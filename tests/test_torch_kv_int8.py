"""The int8 KV cache in the port against the reference's, on the CPU.

Mirrors ``tests/test_kv_cache_int8.py``: the quantizer's round-trip bound
(half a scale), an int8 entry's write and read, and the halved cache
bytes; and, as the port has no training ``forward``, holds the port's
int8 prefill and decode against the reference's own on the same weights
(the reference's ``init_params(cfg, PRNGKey(0))`` carried across by
``repro_torch.models.convert``): the smoke configs of qwen3-8b (global
layers) and gemma2-9b (local layers on rings of 8 rows, which a 20-token
prompt wraps, beside global ones), with ``kv_cache_dtype="int8"``.

Bounds, measured on the CPU: ``quantize_kv`` bitwise the reference's
jitted one (its ``/ 127`` compiles to a product with the float32
reciprocal, which the port mirrors: ROADMAP C7; a true division gives 4.4%
of the scales an ulp away).  Free-running (each package on its own greedy
tokens), every greedy token equal, the caches' scales within 1e-5 / 127
absolute (the keys' 1e-5 float32 bound through ``max|k| / 127``; measured
1.4e-8) and their int8 values equal but at rounding ties: the float32 gap of k (~1e-6, the matmuls' summation
order) carries a quotient lying within 1e-4 of a half-integer across it
(gemma2-9b: 2 values of layer 3's prompt keys, one step apart; ROADMAP
C9).  A key one step apart moves the later logits by up to 2.0e-5, so the
logits are held step by step: the prefill's, and each decode step's run
from the reference's cache after the step before, within 1e-5 of the
reference's (measured 9.5e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import attention as jattn, transformer as jt
from repro.data.synthetic import DataConfig, host_batch
from repro_torch.configs import smoke_config
from repro_torch.models import attention as tattn, convert, transformer as tt

F32_TOL = 1e-5
PROMPT, GEN, BATCH, MAX_LEN = 20, 6, 2, 26
ARCHS = ("qwen3-8b", "gemma2-9b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quantize_roundtrip_bound():
    """Half a scale from the input, and bitwise the reference's jitted
    quantizer in float32 and bfloat16."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 64, 4, 16))
         * rng.uniform(0.01, 30, size=(4, 64, 4, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                    # an all-zero row: the 1e-8 floor
    q, s = tattn.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (4, 64, 4, 1) and float(s[0, 0, 0]) == np.float32(1e-8)
    err = (q.float() * s - torch.from_numpy(x)).abs()
    assert bool((err <= (s * 0.5 + 1e-7) * 1.01).all())
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x).astype(jdt)
        wq, ws = jax.jit(jattn.quantize_kv)(xj)
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
        gq, gs = tattn.quantize_kv(xt)
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_cache_write_read_int8_entry():
    entry = (torch.zeros((1, 4, 2, 8), dtype=torch.int8),
             torch.ones((1, 4, 2, 1), dtype=torch.float32))
    val = torch.full((1, 1, 2, 8), 0.5, dtype=torch.bfloat16)
    tattn.cache_write(entry, val, 2)
    out = tattn.cache_read(entry, torch.bfloat16)
    np.testing.assert_allclose(out[:, 2].float().numpy(), 0.5, rtol=1e-2)
    assert bool((out[:, 0] == 0).all())
    assert int(entry[0][0, 2, 0, 0]) == 127
    # a ring entry: position 5 of a 4-row ring lands in row 1
    tattn.ring_write(entry, torch.full((1, 1, 2, 8), -2.0), 5)
    assert float(tattn.cache_read(entry, torch.float32)[0, 1, 0, 0]) == -2.0


def test_int8_cache_halves_bytes():
    """(B, S, K, hd) int8 values and (B, S, K, 1) float32 scales: under
    half the float32 smoke cache, and (hd + 4) / (2 hd) of a bf16 one."""
    cfg = smoke_config("qwen3-8b")
    nbytes = lambda c: sum(t.nbytes for kv in c for e in kv
                           for t in (e if isinstance(e, tuple) else (e,)))
    fp = nbytes(tt.init_cache(cfg, 2, 64, "cpu"))
    q = nbytes(tt.init_cache(cfg.replace(kv_cache_dtype="int8"), 2, 64,
                             "cpu"))
    assert q < 0.5 * fp
    bf = cfg.replace(compute_dtype="bfloat16")
    fp = nbytes(tt.init_cache(bf, 2, 64, "cpu"))
    q = nbytes(tt.init_cache(bf.replace(kv_cache_dtype="int8"), 2, 64,
                             "cpu"))
    assert q / fp == (16 + 4) / (2 * 16)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = j_smoke(arch).replace(kv_cache_dtype="int8")
    cfg = smoke_config(arch).replace(kv_cache_dtype="int8")
    return jcfg, cfg, _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))


def _run_both(jcfg, cfg, tree, monkeypatch):
    """Prefill and GEN greedy decode steps through both packages, each on
    its own greedy tokens (checked equal).  Returns the two final caches,
    the reference's cache after each step and the tokens it decoded, and
    how many of the port's quantized values lay within 1e-4 of a rounding
    tie (half way between two integers)."""
    ties = []

    def recording(x):
        q, scale = quantize(x)
        r = x.to(torch.float32) / scale
        ties.append(int(((r - r.floor() - 0.5).abs() < 1e-4).sum()))
        return q, scale

    quantize = tattn.quantize_kv
    monkeypatch.setattr(tattn, "quantize_kv", recording)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.params_from_numpy(cfg, tree)
    toks = host_batch(cfg, DataConfig(PROMPT, BATCH, seed=0), 0)["tokens"]
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, max_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    steps = [(_np(jc), None)]
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(GEN):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jc, jl = dec(jp, jc, {"tokens": jtok}, jnp.int32(PROMPT + i))
        tc, tl = tt.decode_step(cfg, tp, tc, {"tokens": ttok}, PROMPT + i)
        steps.append((_np(jc), np.asarray(jtok)))
    return jc, tc, steps, sum(ties)


def test_int8_prefill_and_decode_match_reference(setup, monkeypatch):
    """Free-running, each package on its own greedy tokens: every token
    equal; the caches' scales within 1e-5 / 127 and their int8 values
    equal, but for values one step apart where the port's quotient lay
    within 1e-4 of a rounding tie (gemma2-9b: 2 such values in layer 3's
    prompt keys, quotients 4.50004 and -103.50003: the float32 gap of k
    carries them across; qwen3-8b: none).  gemma2-9b's local rings
    wrapped (8 rows for 26 positions)."""
    jcfg, cfg, tree = setup
    jc, tc, _, ties = _run_both(jcfg, cfg, tree, monkeypatch)
    want = convert.cache_from_numpy(cfg, _np(jc))
    sizes, flips = set(), 0
    for pw, pt in zip(want, tc):
        for (wq, ws), (gq, gs) in zip(pw, pt):
            sizes.add(gq.shape[1])
            assert gq.dtype == wq.dtype == torch.int8
            step = (gq.int() - wq.int()).abs()
            assert int(step.max()) <= 1
            flips += int(step.sum())
            np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=0,
                                       atol=F32_TOL / 127)
    assert flips <= ties
    assert sizes == ({MAX_LEN, cfg.sliding_window}
                     if cfg.sliding_window else {MAX_LEN})


def test_int8_steps_from_reference_cache(setup, monkeypatch):
    """Each step alone: the prefill's logits, and every decode step run
    from the reference's int8 cache after the step before it with the
    reference's token, within 1e-5 of the reference's logits (measured
    1.2e-6), its written row's int8 values equal but at ties."""
    jcfg, cfg, tree = setup
    _, _, steps, _ = _run_both(jcfg, cfg, tree, monkeypatch)
    tp = convert.params_from_numpy(cfg, tree)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = host_batch(cfg, DataConfig(PROMPT, BATCH, seed=0), 0)["tokens"]
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, max_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks)})
    _, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32_TOL)
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(GEN):
        before, (after, tok) = steps[i][0], steps[i + 1]
        _, jl = dec(jp, jax.tree_util.tree_map(jnp.asarray, before),
                    {"tokens": jnp.asarray(tok)}, jnp.int32(PROMPT + i))
        tc = convert.cache_from_numpy(cfg, before)
        _, tl = tt.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
            np.array(tok))}, PROMPT + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=F32_TOL)
        for pw, pt in zip(convert.cache_from_numpy(cfg, after), tc):
            for (wq, _), (gq, _) in zip(pw, pt):
                assert int((gq.int() - wq.int()).abs().max()) <= 1
