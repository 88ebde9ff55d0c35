"""The port's RecurrentGemma serving path (``repro_torch.models.rglru``,
the RG-LRU and local layers of ``repro_torch.models.transformer`` and
``attention``, the scan kernel's plain version and dispatch
``repro_torch.kernels.rglru_scan``) against the reference's, on
recurrentgemma-9b's smoke configuration (6 layers, 2 x [rg, rg,
attn_local], d_model 64, lru_width 64, 4 heads on 1 kv head of 16, window
8, vocab 128) and an 8-layer variant whose stack ends in a tail of [rg,
rg] as the full configuration's does, with the reference's own weights
(``init_params(cfg, PRNGKey(0))``) carried across by
``repro_torch.models.convert``.  The reference initialises ``ba``, ``bx``
and ``conv_b`` to zero, ``lam`` to a constant and the norms to zero;
every model test sets them to seeded normals first, so a swapped bias or
a per-channel error shows.

Tolerances: the scan against the reference's Pallas kernel (interpret
mode) and its oracle at ``tests/test_kernels.py``'s rtol = atol = 1e-5.
The reference's model prefill takes ``lax.associative_scan`` over
``a = exp(log_a)``, the port's the scan kernel, which steps in order: the
float32 sums associate differently.  Measured on the CPU: the two scans
on the same gates lie 2.4e-7 apart (S = 19, |h| up to ~3); the Griffin
block's output (|out| ~1) within 2.4e-7 of the reference's from a zero
state and 1.8e-7 from a seeded one, its new h within 2.4e-7 and 1.2e-7,
its conv state equal; one decode step 1.2e-7 and 6e-8.  All held at
``BLOCK_TOL`` = 1e-6.  Whole model, float32: logits within 1e-5 absolute
(measured 5.1e-7 over 6 and 8 layers, 1.8e-6 on the local/global ring
model) and caches and states within 1e-5 (measured 2.4e-6), every greedy
token equal over prefill and 8 decode steps, which wrap every local
layer's 8-row ring; bfloat16 logits within 2e-2 for the prefill and each
decode step taken from the reference's cache (measured 1.2e-2).  The
CUDA kernel's own test against the plain version needs the card and no
JAX, so it lives in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import DataConfig, host_batch
from repro.kernels.rglru_scan.ops import rglru_scan as j_scan
from repro.kernels.rglru_scan.ref import rglru_ref as j_rglru_ref
from repro.launch import serve as j_serve
from repro.models import attention as ja, rglru as jr, transformer as jt
from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels.rglru_scan import kernel, ops
from repro_torch.kernels.rglru_scan.ref import rglru_ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import (attention as ta, convert, rglru as tr,
                                transformer as tt)
from test_torch_lm import _as_dicts, _np

ARCH = "recurrentgemma-9b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
BLOCK_TOL = 1e-6
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_kernels.py's
PROMPT, GEN, BATCH = 19, 8, 2
DEPTHS = [6, 8]                           # 8: a tail of [rg, rg]
# tests/test_kernels.py's scan shapes (B, T, W) and chunks
SCAN_CASES = [((2, 128, 32), 32), ((1, 256, 64), 128), ((3, 64, 16), 64)]


def _cfgs(dtype="float32", n_layers=6):
    return (j_smoke(ARCH).replace(compute_dtype=dtype, n_layers=n_layers),
            smoke_config(ARCH).replace(compute_dtype=dtype,
                                       n_layers=n_layers))


def _perturb(params, seed=1):
    """The reference's parameters with the zero-initialised ``ba``,
    ``bx``, ``conv_b`` and norms, and the constant ``lam``, set to seeded
    normals."""
    rng = np.random.default_rng(seed)
    normal = lambda a, scale: jnp.asarray(
        rng.normal(size=np.shape(a)) * scale, jnp.float32)

    def layers(tree):
        out = {}
        for name, node in tree.items():
            node = dict(node, ln1=normal(node["ln1"], 0.3),
                        ln2=normal(node["ln2"], 0.3))
            if "rg" in node:
                rg = node["rg"]
                node["rg"] = rg._replace(
                    ba=normal(rg.ba, 0.5), bx=normal(rg.bx, 0.5),
                    conv_b=normal(rg.conv_b, 0.5), lam=normal(rg.lam, 1.0))
            out[name] = node
        return out

    p = dict(params, blocks=layers(params["blocks"]),
             final_norm=normal(params["final_norm"], 0.3))
    if "tail" in params:
        p["tail"] = layers(params["tail"])
    return p


@pytest.fixture(scope="module")
def ref_params():
    """Perturbed reference parameters per depth."""
    return {n: _perturb(jt.init_params(_cfgs(n_layers=n)[0],
                                       jax.random.PRNGKey(0)))
            for n in DEPTHS}


def _prompt(cfg, s=PROMPT):
    return host_batch(cfg, DataConfig(s, BATCH, seed=0), 0)["tokens"]


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _cache_err(cfg, jc, tc):
    want = convert.cache_from_numpy(cfg, _np(jc))
    assert len(want) == len(tc) == cfg.n_layers
    for w, t in zip(want, tc):
        assert all(a.shape == b.shape and a.dtype == b.dtype
                   for a, b in zip(w, t))
    return max((a.float() - b.float()).abs().max().item()
               for w, t in zip(want, tc) for a, b in zip(w, t))


# ------------------------------------------------------------ the scan ----
def _scan_inputs(shape, seed=0):
    """log_a, b and h0 as tests/test_kernels.py draws them."""
    b, t, w = shape
    rng = np.random.default_rng(seed)
    log_a = (-np.exp(rng.normal(size=shape))).astype(np.float32)
    bb = rng.normal(size=shape).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return log_a, bb, h0


@pytest.mark.parametrize("shape,chunk", SCAN_CASES)
def test_rglru_ref_matches_reference_ref(shape, chunk):
    log_a, bb, h0 = _scan_inputs(shape)
    yw, hw = j_rglru_ref(*(jnp.asarray(a) for a in (log_a, bb, h0)))
    y, h = rglru_ref(*_t(log_a, bb, h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), **SCAN_TOL)


@pytest.mark.parametrize("shape,chunk", SCAN_CASES)
def test_ops_matches_pallas_interpret(shape, chunk):
    """``ops.rglru_scan`` on the CPU, ``h0`` folded in, against the
    reference's Pallas kernel in interpret mode and against its oracle on
    the folded ``b``, as ``tests/test_kernels.py`` holds the kernel."""
    log_a, bb, h0 = _scan_inputs(shape)
    jin = [jnp.asarray(a) for a in (log_a, bb, h0)]
    yw, hw = j_scan(*jin, chunk=chunk, interpret=True)
    b_ref = jin[1].at[:, 0, :].add(jnp.exp(jin[0][:, 0, :]) * jin[2])
    yr, hr = j_rglru_ref(jin[0], b_ref, jnp.zeros(h0.shape))
    y, h = ops.rglru_scan(*_t(log_a, bb, h0))
    assert y.dtype == h.dtype == torch.float32
    for got, want in ((y, yw), (h, hw), (y, yr), (h, hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **SCAN_TOL)


@pytest.mark.parametrize("t_len", [1, 37])
def test_ops_folds_h0_and_takes_any_length(t_len):
    """The fold equals stepping from ``h0``, at lengths no chunk divides;
    the inputs are left as they were."""
    log_a, bb, h0 = _t(*_scan_inputs((2, t_len, 24), seed=3))
    b_before = bb.clone()
    y, h = ops.rglru_scan(log_a, bb, h0)
    yr, hr = rglru_ref(log_a, bb, h0)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), **SCAN_TOL)
    assert torch.equal(bb, b_before)
    y0, h0_fin = ops.rglru_scan(log_a, bb)
    assert torch.equal(y0, rglru_ref(log_a, bb, torch.zeros_like(h0))[0])
    assert torch.equal(h0_fin, y0[:, -1])


def test_kernel_wrapper_refuses_cpu_tensors_and_missing_nvcc(
        monkeypatch, tmp_path):
    """The CUDA wrapper takes no CPU tensor (``ops`` sends those to the
    plain version), and the build raises when no ``nvcc`` is found."""
    log_a, bb, _ = _t(*_scan_inputs(SCAN_CASES[0][0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.rglru_scan(log_a, bb)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel._load()


# ---------------------------------------------------- the Griffin block ----
def _block(ref_params, cfg):
    tp = convert.params_from_numpy(cfg, _np(ref_params[6]))
    return tp.layers[0].rg, jax.tree_util.tree_map(
        lambda a: a[0], ref_params[6]["blocks"]["l0_rg"]["rg"])


def _seeded_state(cfg, seed=3):
    rng = np.random.default_rng(seed)
    w = cfg.lru_width
    conv = rng.normal(size=(BATCH, cfg.conv1d_width - 1, w)) \
        .astype(np.float32)
    h = rng.normal(size=(BATCH, w)).astype(np.float32)
    return (jr.RGLRUState(jnp.asarray(conv), jnp.asarray(h)),
            tr.RGLRUState(*_t(conv, h)))


@pytest.mark.parametrize("s,seeded", [(PROMPT, False), (PROMPT, True),
                                      (1, True)])
def test_recurrent_block_matches_reference(ref_params, s, seeded):
    """The block over a 19-token prompt from a zero and a seeded state,
    and one decode step: output and new conv and h states."""
    jcfg, cfg = _cfgs()
    tp, jp = _block(ref_params, cfg)
    x = np.random.default_rng(4).normal(size=(BATCH, s, cfg.d_model)) \
        .astype(np.float32)
    if seeded:
        js, ts = _seeded_state(cfg)
    else:
        js, ts = jr.init_state(jcfg, BATCH), tr.init_state(cfg, BATCH)
    jo, js2 = jr.recurrent_block(jcfg, jp, jnp.asarray(x), js)
    to, ts2 = tr.recurrent_block(cfg, tp, torch.from_numpy(x), ts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=BLOCK_TOL)
    for a, b in zip(ts2, js2):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=BLOCK_TOL)
    jo, _ = jr.recurrent_block(jcfg, jp, jnp.asarray(x), None)
    to, none = tr.recurrent_block(cfg, tp, torch.from_numpy(x), None)
    assert none is None
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("s", [PROMPT, 2, 1])
def test_block_sends_prompts_to_the_scan(ref_params, monkeypatch, s):
    """A prompt of more than one token goes through ``ops.rglru_scan``
    (the kernel on the card) from the layer's state; decode takes the
    model's own step function."""
    _, cfg = _cfgs()
    tp, _ = _block(ref_params, cfg)
    seen = []
    real = ops.rglru_scan
    monkeypatch.setattr(ops, "rglru_scan",
                        lambda *a: seen.append(a[2]) or real(*a))
    _, ts = _seeded_state(cfg)
    x = torch.randn((BATCH, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    tr.recurrent_block(cfg, tp, x, ts)
    assert len(seen) == int(s > 1)
    if s > 1:
        assert seen[0] is ts.h


# ---------------------------------------------------- the rolling ring ----
def _mixed_cfgs(dtype="float32"):
    """Qwen3-8B's smoke config with a local (window 8) and a global
    layer."""
    upd = dict(compute_dtype=dtype, global_every=2, sliding_window=8)
    return j_smoke("qwen3-8b").replace(**upd), \
        smoke_config("qwen3-8b").replace(**upd)


def _run_both(jcfg, cfg, rp, steps=GEN, s=PROMPT):
    """Prefill a prompt of ``s`` tokens and ``steps`` greedy decode steps
    through both packages (cache capacity ``s + steps``), the tokens held
    equal at every step; returns per step (reference logits, port
    logits) and the two final caches."""
    tp = convert.params_from_numpy(cfg, _np(rp))
    toks = _prompt(cfg, s)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b,
                                             max_len=s + steps))(
        rp, {"tokens": jnp.asarray(toks)})
    tc, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_len=s + steps)
    out = [(np.asarray(jl), tl.numpy())]
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(steps):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jc, jl = dec(rp, jc, {"tokens": jtok}, jnp.int32(s + i))
        tc, tl = tt.decode_step(cfg, tp, tc, {"tokens": ttok}, s + i)
        out.append((np.asarray(jl), tl.numpy()))
    return out, jc, tc


@pytest.mark.parametrize("s", [5, 19])
def test_ring_cache_matches_reference(s):
    """A local and a global layer: the prompt fills part of the 8-row ring
    (5) or wraps it (19), then 8 decode steps wrap it again.  Every row of
    both layers' caches after the prefill and after the last step, every
    step's logits and every greedy token equal the reference's."""
    jcfg, cfg = _mixed_cfgs()
    rp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    _, jc0, tc0 = _run_both(jcfg, cfg, rp, steps=0, s=s)
    assert tc0[0][0].shape[1] == min(8, s) and tc0[1][0].shape[1] == s
    assert _cache_err(cfg, jc0, tc0) <= F32_TOL
    out, jc, tc = _run_both(jcfg, cfg, rp, s=s)
    local, glob = tc
    assert local[0].shape[1] == 8 and glob[0].shape[1] == s + GEN
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _cache_err(cfg, jc, tc) <= F32_TOL


@pytest.mark.parametrize("pos", [3, 7, 8, 13, 26])
def test_ring_decode_matches_rolling_scores(pos):
    """One decode step of a local layer on a ring of 8 rows: the port's
    ``attend`` (K3 over the ring's first ``min(pos + 1, 8)`` rows) against
    the reference's ``attend(rolling=True)``, and the attention itself
    against both packages' plain ``attention_scores(rolling=True)``."""
    jcfg, cfg = _mixed_cfgs()
    rp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                rp["blocks"]["l0_attn_local"]["attn"])
    tp = convert.params_from_numpy(cfg, _np(rp)).layers[0].attn
    rng = np.random.default_rng(pos)
    hd, size = cfg.resolved_head_dim, 8
    ring = [rng.normal(size=(BATCH, size, cfg.n_kv_heads, hd))
            .astype(np.float32) for _ in range(2)]
    x = rng.normal(size=(BATCH, 1, cfg.d_model)).astype(np.float32)
    n = min(pos + 1, size)
    jo, (jk, jv) = ja.attend(
        jcfg, jp, jnp.asarray(x), jnp.full((BATCH, 1), pos), layer_window=0,
        cache_kv=tuple(jnp.asarray(r) for r in ring), cache_pos=pos % size,
        kv_valid_len=n, rolling=True)
    tk, tv = _t(*(r.copy() for r in ring))
    to, _ = ta.attend(cfg, tp, torch.from_numpy(x),
                      torch.full((BATCH, 1), pos), layer_window=size,
                      cache_kv=(tk, tv), cache_pos=pos)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=F32_TOL)
    # the new row at pos % 8 (projected and rotated: within the bound),
    # every other row as it was
    others = np.arange(size) != pos % size
    for got, want, before in ((tk, jk, ring[0]), (tv, jv, ring[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_TOL)
        np.testing.assert_array_equal(got.numpy()[:, others],
                                      before[:, others])

    q = rng.normal(size=(BATCH, 1, cfg.n_heads, hd)).astype(np.float32)
    want = ja.attention_scores(jnp.asarray(q), jk, jv, causal_offset=0,
                               kv_len_valid=n, rolling=True)
    plain = ta.attention_scores(torch.from_numpy(q), tk, tv,
                                causal_offset=0, kv_len_valid=n,
                                rolling=True)
    got = ta.fa_ops.flash_attention(torch.from_numpy(q), tk[:, :n],
                                    tv[:, :n], causal=True, window=0)
    for a in (plain, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_TOL)


@pytest.mark.parametrize("s,pos,size", [(5, 0, 8), (19, 0, 8), (1, 8, 8),
                                        (3, 6, 8), (20, 3, 4)])
def test_ring_write_keeps_the_last_rows(s, pos, size):
    """Position ``t`` lands in row ``t % size`` and only the last ``size``
    positions are kept."""
    entry = torch.full((1, size, 1, 1), -1.0)
    val = torch.arange(pos, pos + s, dtype=torch.float32).view(1, s, 1, 1)
    ta.ring_write(entry, val, pos)
    want = torch.full((size,), -1.0)
    for t in range(max(pos, pos + s - size), pos + s):
        want[t % size] = t
    assert torch.equal(entry.view(-1), want)


# -------------------------------------------------------------- serving ----
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_prefill_matches_reference(ref_params, n_layers):
    """Last-token logits and every layer's cache (rings, conv and h
    states) after a 19-token prompt, which wraps the 8-row rings."""
    jcfg, cfg = _cfgs(n_layers=n_layers)
    out, jc, tc = _run_both(jcfg, cfg, ref_params[n_layers], steps=0)
    want, got = out[0]
    assert got.shape == want.shape == (BATCH, 1, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _cache_err(cfg, jc, tc) <= F32_TOL


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_decode_steps_match_reference(ref_params, n_layers):
    """Eight greedy decode steps: logits within the bound, every token
    equal (checked step by step inside ``_run_both``), caches too."""
    jcfg, cfg = _cfgs(n_layers=n_layers)
    out, jc, tc = _run_both(jcfg, cfg, ref_params[n_layers])
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _cache_err(cfg, jc, tc) <= F32_TOL


def test_bf16_matches_reference(ref_params):
    """bfloat16 compute (the embedding scale and the attention in bf16,
    the recurrent block in float32): free-running, every greedy token
    equal (checked inside ``_run_both``); the prefill's logits and each
    decode step's, the step taken from the reference's cache carried
    across, within 2e-2."""
    jcfg, cfg = _cfgs("bfloat16", 8)
    rp = ref_params[8]
    _run_both(jcfg, cfg, rp)
    tp = convert.params_from_numpy(cfg, _np(rp))
    toks = _prompt(cfg)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b,
                                             max_len=PROMPT + GEN))(
        rp, {"tokens": jnp.asarray(toks)})
    _, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       max_len=PROMPT + GEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=BF16_TOL)
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(GEN):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        tc = convert.cache_from_numpy(cfg, _np(jc))
        jc, jl = dec(rp, jc, {"tokens": tok}, jnp.int32(PROMPT + i))
        _, tl = tt.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
            np.array(tok))}, PROMPT + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=BF16_TOL)


def test_decode_from_reference_cache(ref_params):
    """Decoding from the reference's prefill cache carried across equals
    decoding from the port's own cache, and the reference's step."""
    jcfg, cfg = _cfgs(n_layers=8)
    rp = ref_params[8]
    toks = _prompt(cfg)
    jc, jl = jt.prefill(jcfg, rp, {"tokens": jnp.asarray(toks)},
                        max_len=PROMPT + GEN)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    tc = convert.cache_from_numpy(cfg, _np(jc))
    kinds = tt.layer_kinds(cfg)
    assert all(isinstance(c, tr.RGLRUState) == (k == "rg")
               for k, c in zip(kinds, tc))
    tp = convert.params_from_numpy(cfg, _np(rp))
    own, _ = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_len=PROMPT + GEN)
    ttok = {"tokens": torch.from_numpy(np.array(tok))}
    jc2, jl2 = jt.decode_step(jcfg, rp, jc, {"tokens": tok},
                              jnp.int32(PROMPT))
    tc2, tl2 = tt.decode_step(cfg, tp, tc, ttok, PROMPT)
    _, tl_own = tt.decode_step(cfg, tp, own, ttok, PROMPT)
    for got in (tl2, tl_own):
        np.testing.assert_allclose(got.numpy(), np.asarray(jl2), rtol=0,
                                   atol=F32_TOL)
    np.testing.assert_allclose(tl2.numpy(), tl_own.numpy(), rtol=0,
                               atol=F32_TOL)
    assert _cache_err(cfg, jc2, tc2) <= F32_TOL


def test_serve_matches_reference(ref_params, monkeypatch):
    """``serve`` on the CPU against the reference's ``serve`` on the same
    prompts and (perturbed) weights, the 8-layer stack: every generated
    token equal, each step's logits within 1e-5 of its prefill's and
    decode's."""
    jcfg, cfg = _cfgs(n_layers=8)
    rp = ref_params[8]
    monkeypatch.setattr(j_serve.transformer, "init_params",
                        lambda c, key: rp)
    want = j_serve.serve(jcfg, BATCH, PROMPT, GEN, seed=0)
    got = t_serve.serve(cfg, BATCH, PROMPT, GEN, seed=0, device="cpu",
                        params=convert.params_from_numpy(cfg, _np(rp)))
    assert got["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["logits"].shape == (BATCH, GEN, 128)
    np.testing.assert_array_equal(
        got["logits"].argmax(-1).numpy(), got["generated"])


# ------------------------------------------------------------ parameters ----
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_params_round_trip(ref_params, n_layers):
    """Reference tree -> port modules -> reference tree, bit for bit,
    stacked blocks and the tail."""
    _, cfg = _cfgs(n_layers=n_layers)
    rp = ref_params[n_layers]
    assert ("tail" in rp) == (n_layers == 8)
    tp = convert.params_from_numpy(cfg, _np(rp))
    assert len(tp.layers) == cfg.n_layers
    assert [type(l) for l in tp.layers[:3]] == [tt.RgLayer, tt.RgLayer,
                                                tt.Layer]
    assert isinstance(tp.layers[-1], tt.RgLayer if "tail" in rp else tt.Layer)
    assert tp.layers[0].rg.conv_w.shape == (4, 64)
    assert tp.lm_head is None
    want = jax.tree_util.tree_leaves_with_path(_as_dicts(rp))
    got = jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(cfg, tp))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_params_follows_the_reference_distributions():
    """The port's own random weights: the reference's shapes, constants
    and zero-initialised parameters, float32; the compute copy keeps the
    RG-LRU blocks' weights in float32 and shared, and casts the MLP, the
    attention and the head."""
    jcfg, cfg = _cfgs("bfloat16", 8)
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_leaves_with_path(_as_dicts(
        jt.init_params(jcfg, jax.random.PRNGKey(0))))
    got = jax.tree_util.tree_leaves_with_path(convert.params_to_numpy(cfg, p))
    assert [(q, a.shape) for q, a in got] == [(q, a.shape) for q, a in shapes]
    assert all(t.dtype == torch.float32 for t in p.parameters())
    rg = p.layers[0].rg
    for z in (rg.ba, rg.bx, rg.conv_b):
        assert not z.any()
    assert torch.all(rg.lam == -3.0)
    # conv_w's fan-in is its 4 taps (in_axis=0): |w| <= 2 / sqrt(4)
    assert rg.conv_w.abs().max() <= 1.0 and rg.conv_w.std() > 0.3
    assert rg.wa.abs().max() <= 2.0 / 64 ** 0.5
    copy = tt.compute_copy(cfg, p)
    assert copy.layers[0].rg is p.layers[0].rg
    assert copy.layers[0].mlp.w_up.dtype == torch.bfloat16
    assert copy.layers[2].attn.wq.dtype == torch.bfloat16
    assert copy.lm_head.dtype == torch.bfloat16


def test_embedding_scale_rounds_to_the_compute_dtype():
    """sqrt(d_model) is held in the compute dtype before the multiply, as
    the reference does: at d_model 96, sqrt is not a bfloat16 number."""
    _, cfg = _cfgs("bfloat16")
    cfg = cfg.replace(d_model=96)
    params = tt.Transformer([], torch.randn(
        (8, 96), generator=torch.Generator().manual_seed(0)), None,
        torch.zeros(96))
    h = tt.embed_tokens(cfg, params, torch.arange(8)[None])
    scale = torch.tensor(96 ** 0.5, dtype=torch.bfloat16)
    assert h.dtype == torch.bfloat16
    assert torch.equal(h, params.embed[None].to(torch.bfloat16) * scale)
    j = jt.embed_tokens(
        j_smoke(ARCH).replace(compute_dtype="bfloat16", d_model=96),
        {"embed": jnp.asarray(params.embed.numpy())},
        {"tokens": jnp.arange(8)[None]})
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


def test_full_width_config_is_recurrentgemma_9b():
    cfg = get_arch(ARCH)
    tt.check_supported(cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.lru_width, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.sliding_window,
            cfg.d_ff, cfg.vocab, cfg.conv1d_width, cfg.act,
            cfg.compute_dtype) == (38, 4096, 4096, 16, 1, 256, 2048, 12288,
                                   256000, 4, "gelu", "bfloat16")
    assert cfg.embed_scale and cfg.tie_embeddings
    kinds = tt.layer_kinds(cfg)
    assert kinds == ["rg", "rg", "attn_local"] * 12 + ["rg", "rg"]
    assert kinds.count("rg") == 26 and kinds.count("attn_local") == 12
