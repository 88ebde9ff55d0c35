"""The port's RWKV-6 serving path (``repro_torch.models.rwkv6``, the RWKV
layers of ``repro_torch.models.transformer``, the scan kernel's plain
version and dispatch ``repro_torch.kernels.rwkv6_scan``) against the
reference's, on rwkv6-3b's smoke configuration (2 layers, d_model 64, 4
heads of 16, vocab 128), with the reference's own weights
(``init_params(cfg, PRNGKey(0))``) carried across by
``repro_torch.models.convert``.  The reference initialises ``u``, both
LoRA-b matrices and the group norm's ``ln_w`` to zero; every model test
sets them to seeded normals first, so the bonus, the LoRA mixing and the
data-dependent decay are compared too.

Tolerances: the scan against the reference's Pallas kernel at 1e-4 (the
reference's own; measured max abs 3.4e-5); the two
step-by-step oracles against each other and the nonzero-state scan
against the reference's ``wkv_chunked`` at rtol = atol = 2e-5 (measured
max abs 1.5e-5 and 2.9e-5: both are float32 recurrences with their own
rounding); float32 logits within 1e-5 absolute and recurrent states
within 1e-5 (measured on the CPU: logits 4.2e-6, states 4.3e-6, the order
of summation in the float32 matmuls), every greedy token equal; bfloat16
logits within 2e-2 absolute for the prefill and for each decode step
taken from the reference's state (measured 1.6e-2, one bfloat16 step at
|logit| in [2, 4): the residual stream is rounded to bfloat16 after each
mix, and a float32 gap of 1e-6 moves a rounding now and then).  Decoding
free-running, those moved roundings add up over the steps (measured
2.5e-2 after eight), so there the greedy tokens are held equal.
The CUDA kernel's own test against the plain version needs the card and
no JAX, so it lives in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import DataConfig, host_batch
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_scan
from repro.kernels.rwkv6_scan.ref import wkv_ref as j_wkv_ref
from repro.launch import serve as j_serve
from repro.models import rwkv6 as jr, transformer as jt
from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels import nvcc
from repro_torch.kernels.rwkv6_scan import kernel, ops
from repro_torch.kernels.rwkv6_scan.ref import wkv_ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import convert, rwkv6 as tr, transformer as tt
from test_torch_lm import _as_dicts, _np

F32_TOL = 1e-5
STATE_TOL = 1e-5
BF16_TOL = 2e-2
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py's
REF_TOL = dict(rtol=2e-5, atol=2e-5)
PROMPT, GEN, BATCH = 32, 8, 2
ARCH = "rwkv6-3b"
# tests/test_kernels.py's scan shapes (B, H, T, K)
SCAN_SHAPES = [(1, 2, 32, 16), (2, 4, 64, 32), (1, 1, 128, 64)]


def _cfgs(dtype="float32"):
    return (j_smoke(ARCH).replace(compute_dtype=dtype),
            smoke_config(ARCH).replace(compute_dtype=dtype))


def _perturb(params, seed=1):
    """The reference's parameters with the zero-initialised ``u``,
    ``mix_lora_b``, ``w_lora_b`` and ``ln_w`` set to seeded normals."""
    rng = np.random.default_rng(seed)
    normal = lambda a, scale: jnp.asarray(
        rng.normal(size=a.shape) * scale, jnp.float32)
    blocks = dict(params["blocks"])
    for name, node in blocks.items():
        tm = node["tm"]
        blocks[name] = dict(node, tm=tm._replace(
            u=normal(tm.u, 0.5), mix_lora_b=normal(tm.mix_lora_b, 0.5),
            w_lora_b=normal(tm.w_lora_b, 0.5), ln_w=normal(tm.ln_w, 0.5)))
    return dict(params, blocks=blocks)


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    return _perturb(jt.init_params(jcfg, jax.random.PRNGKey(0)))


def _prompt(cfg, s=PROMPT):
    return host_batch(cfg, DataConfig(s, BATCH, seed=0), 0)["tokens"]


def _scan_inputs(shape, seed=0, s0=False):
    """r, k, v, logw (as tests/test_kernels.py draws them), u and a zero
    or random initial state, as numpy."""
    b, h, t, k = shape
    rng = np.random.default_rng(seed)
    mk = lambda: rng.normal(size=shape).astype(np.float32)
    r, kk, v = mk(), mk(), mk()
    logw = np.maximum(-np.exp(rng.normal(size=shape) * 0.5),
                      -4.0).astype(np.float32)
    u = rng.normal(size=(h, k)).astype(np.float32)
    state = (rng.normal(size=(b, h, k, k)) if s0
             else np.zeros((b, h, k, k))).astype(np.float32)
    return r, kk, v, logw, u, state


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _state_err(cfg, jc, tc):
    want = convert.cache_from_numpy(cfg, _np(jc))
    assert len(want) == len(tc) == cfg.n_layers
    return max((a.float() - b.float()).abs().max().item()
               for sw, st in zip(want, tc) for a, b in zip(sw, st))


# ------------------------------------------------------------ the scan ----
@pytest.mark.parametrize("s0", [False, True])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_wkv_ref_matches_reference_ref(shape, s0):
    r, k, v, lw, u, st = _scan_inputs(shape, s0=s0)
    yw, sw = j_wkv_ref(*(jnp.asarray(a) for a in (r, k, v, lw, u, st)))
    y, s = wkv_ref(*_t(r, k, v, lw, u, st))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), **REF_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), **REF_TOL)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_ops_matches_pallas_interpret(shape):
    """``ops.rwkv6_scan`` on the CPU against the reference's Pallas kernel
    in interpret mode (zero initial state), at the reference's 1e-4."""
    r, k, v, lw, u, _ = _scan_inputs(shape)
    yw, sw = j_scan(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                    interpret=True)
    y, s = ops.rwkv6_scan(*_t(r, k, v, lw, u))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), **SCAN_TOL)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_ops_with_state_matches_wkv_chunked(shape):
    """A nonzero initial state, as the model's chunked prefill passes it,
    against the reference's ``wkv_chunked``."""
    r, k, v, lw, u, st = _scan_inputs(shape, seed=2, s0=True)
    yw, sw = jr.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, lw, u, st)))
    y, s = ops.rwkv6_scan(*_t(r, k, v, lw, u, st))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), **REF_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), **REF_TOL)


@pytest.mark.parametrize("seed,decay", [(0, 0.1), (7, 1.0), (42, 3.5)])
def test_ops_state_composition(seed, decay):
    """Scanning T tokens equals scanning two halves with the state carried
    (tests/test_kernels.py's property, through ``ops``)."""
    rng = np.random.default_rng(seed)
    b, h, t, k = 1, 2, 64, 16
    mk = lambda: rng.normal(size=(b, h, t, k)).astype(np.float32)
    r, kk, v = _t(mk(), mk(), mk())
    lw = torch.from_numpy(np.maximum(
        -decay * np.abs(rng.normal(size=(b, h, t, k))), -4.0)
        .astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(h, k)).astype(np.float32))
    y_full, s_full = ops.rwkv6_scan(r, kk, v, lw, u)
    half = slice(None, t // 2), slice(t // 2, None)
    part = lambda x, i: x[:, :, half[i]]
    _, s1 = ops.rwkv6_scan(*(part(x, 0) for x in (r, kk, v, lw)), u)
    y2, s2 = ops.rwkv6_scan(*(part(x, 1) for x in (r, kk, v, lw)), u, s1)
    np.testing.assert_allclose(y_full[:, :, t // 2:].numpy(), y2.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_full.numpy(), s2.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ops_clamps_the_log_decay():
    r, k, v, lw, u, _ = _scan_inputs(SCAN_SHAPES[0])
    low = lw - 10.0
    y1, s1 = ops.rwkv6_scan(*_t(r, k, v, low, u))
    y2, s2 = ops.rwkv6_scan(*_t(r, k, v, np.maximum(low, -4.0), u))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_kernel_wrapper_refuses_cpu_tensors_and_missing_nvcc(
        monkeypatch, tmp_path):
    """The CUDA wrapper takes no CPU tensor (``ops`` sends those to the
    plain version), and the build raises when no ``nvcc`` is found."""
    r, k, v, lw, u, _ = _t(*_scan_inputs(SCAN_SHAPES[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.rwkv6_scan(r, k, v, lw, u)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel._load()


# ----------------------------------------------------------- the mixes ----
def _layer(params, cfg):
    tp = convert.params_from_numpy(cfg, _np(params))
    return tp.layers[0], jax.tree_util.tree_map(lambda a: a[0],
                                                params["blocks"]["l0_rwkv"])


def _random_state(cfg, seed=3):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    arrs = [rng.normal(size=(BATCH, d)), rng.normal(size=(BATCH, d)),
            rng.normal(size=(BATCH, d // hd, hd, hd))]
    arrs = [a.astype(np.float32) for a in arrs]
    return (jr.RwkvState(*(jnp.asarray(a) for a in arrs)),
            tr.RwkvState(*_t(*arrs)))


@pytest.mark.parametrize("s", [32, 19, 1])
def test_time_and_channel_mix_match_reference(ref_params, s):
    """Both mixes from a random state, over a chunked (32), a sequential
    (19) and a decode-sized (1) input: outputs and new states."""
    jcfg, cfg = _cfgs()
    tl, jl = _layer(ref_params, cfg)
    x = np.random.default_rng(4).normal(size=(BATCH, s, cfg.d_model)) \
        .astype(np.float32)
    js, ts = _random_state(cfg)
    jo, js2 = jr.time_mix(jcfg, jl["tm"], jnp.asarray(x), js)
    to, ts2 = tr.time_mix(cfg, tl.tm, torch.from_numpy(x), ts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=F32_TOL)
    jo2, js3 = jr.channel_mix(jcfg, jl["cm"], jo, js2)
    to2, ts3 = tr.channel_mix(cfg, tl.cm, torch.from_numpy(np.asarray(jo)),
                              ts2)
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), rtol=0,
                               atol=F32_TOL)
    for a, b in zip(ts3, js3):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=STATE_TOL)


@pytest.mark.parametrize("s,chunked", [(32, True), (19, False), (1, False)])
def test_time_mix_sends_chunked_prompts_to_the_scan(ref_params,
                                                    monkeypatch, s, chunked):
    """A prompt of a multiple of 16 tokens, more than one, goes through
    ``ops.rwkv6_scan`` (the kernel on the card) from the layer's state;
    other lengths take the model's own step function."""
    _, cfg = _cfgs()
    tl, _ = _layer(ref_params, cfg)
    seen = []
    real = ops.rwkv6_scan
    monkeypatch.setattr(ops, "rwkv6_scan",
                        lambda *a: seen.append(a[5]) or real(*a))
    _, ts = _random_state(cfg)
    x = torch.randn((BATCH, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    tr.time_mix(cfg, tl.tm, x, ts)
    assert len(seen) == int(chunked)
    if chunked:
        assert seen[0] is ts.wkv


# -------------------------------------------------------------- serving ----
def _run_both(dtype, ref_params, steps=GEN, s=PROMPT):
    """Prefill a prompt of ``s`` tokens and ``steps`` greedy decode steps
    through both packages; returns per step (reference logits, port
    logits) and the two final caches."""
    jcfg, cfg = _cfgs(dtype)
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    toks = _prompt(cfg, s)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b))(
        ref_params, {"tokens": jnp.asarray(toks)})
    tc, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)})
    out = [(np.asarray(jl), tl.numpy())]
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(steps):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jc, jl = dec(ref_params, jc, {"tokens": jtok}, jnp.int32(s + i))
        tc, tl = tt.decode_step(cfg, tp, tc, {"tokens": ttok}, s + i)
        out.append((np.asarray(jl), tl.numpy()))
    return out, jc, tc


@pytest.mark.parametrize("s", [32, 19])
def test_prefill_matches_reference(ref_params, s):
    """Last-token logits and every layer's state after a chunked (32) and
    a sequential (19) prompt."""
    out, jc, tc = _run_both("float32", ref_params, steps=0, s=s)
    want, got = out[0]
    assert got.shape == want.shape == (BATCH, 1, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _state_err(_cfgs()[1], jc, tc) <= STATE_TOL


def test_decode_steps_match_reference(ref_params):
    """Eight greedy decode steps: logits within the bound, every token
    equal (checked step by step inside ``_run_both``), states too."""
    out, jc, tc = _run_both("float32", ref_params)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _state_err(_cfgs()[1], jc, tc) <= STATE_TOL


def test_bf16_matches_reference(ref_params):
    """bfloat16 compute: the prefill's logits and each of eight decode
    steps' logits, the step taken from the reference's state carried
    across, within 2e-2; free-running, every greedy token equal (checked
    inside ``_run_both``)."""
    _run_both("bfloat16", ref_params)
    jcfg, cfg = _cfgs("bfloat16")
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    toks = _prompt(cfg)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b))(
        ref_params, {"tokens": jnp.asarray(toks)})
    _, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=BF16_TOL)
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(GEN):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        tc = convert.cache_from_numpy(cfg, _np(jc))
        jc, jl = dec(ref_params, jc, {"tokens": tok}, jnp.int32(PROMPT + i))
        _, tl = tt.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
            np.array(tok))}, PROMPT + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=BF16_TOL)


def test_decode_from_reference_cache(ref_params):
    """One decode step from the reference's prefill states carried
    across."""
    jcfg, cfg = _cfgs()
    toks = _prompt(cfg)
    jc, jl = jt.prefill(jcfg, ref_params, {"tokens": jnp.asarray(toks)})
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    tc = convert.cache_from_numpy(cfg, _np(jc))
    assert all(isinstance(c, tr.RwkvState) for c in tc)
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    jc2, jl2 = jt.decode_step(jcfg, ref_params, jc, {"tokens": tok},
                              jnp.int32(PROMPT))
    tc2, tl2 = tt.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
        np.array(tok))}, PROMPT)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=F32_TOL)
    assert _state_err(cfg, jc2, tc2) <= STATE_TOL


def test_serve_matches_reference(ref_params, monkeypatch):
    """``serve`` on the CPU against the reference's ``serve`` on the same
    prompts and (perturbed) weights: every generated token equal."""
    jcfg, cfg = _cfgs()
    monkeypatch.setattr(j_serve.transformer, "init_params",
                        lambda c, key: ref_params)
    want = j_serve.serve(jcfg, BATCH, PROMPT, GEN, seed=0)
    got = t_serve.serve(cfg, BATCH, PROMPT, GEN, seed=0, device="cpu",
                        params=convert.params_from_numpy(cfg,
                                                         _np(ref_params)))
    assert got["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["logits"].shape == (BATCH, GEN, 128)
    np.testing.assert_array_equal(
        got["logits"].argmax(-1).numpy(), got["generated"])


# ------------------------------------------------------------ parameters ----
def test_params_round_trip(ref_params):
    """Reference tree -> port modules -> reference tree, bit for bit."""
    _, cfg = _cfgs()
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    assert len(tp.layers) == cfg.n_layers
    assert isinstance(tp.layers[1], tt.RwkvLayer)
    assert tp.layers[1].tm.mix_lora_a.shape == (5, 64, 32)
    assert tp.layers[1].cm.wk.shape == (64, 96)
    want = jax.tree_util.tree_leaves_with_path(_as_dicts(ref_params))
    got = jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(cfg, tp))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_params_follows_the_reference_distributions():
    """The port's own random weights: the reference's shapes, constants
    and zero-initialised parameters, float32; the compute copy keeps the
    RWKV layers' weights in float32 and casts only the head."""
    jcfg, cfg = _cfgs("bfloat16")
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_leaves_with_path(_as_dicts(
        jt.init_params(jcfg, jax.random.PRNGKey(0))))
    got = jax.tree_util.tree_leaves_with_path(convert.params_to_numpy(cfg, p))
    assert [(q, a.shape) for q, a in got] == [(q, a.shape) for q, a in shapes]
    assert all(t.dtype == torch.float32 for t in p.parameters())
    tm, cm = p.layers[0].tm, p.layers[0].cm
    for z in (tm.mix_lora_b, tm.w_lora_b, tm.u, tm.ln_w):
        assert not z.any()
    assert torch.all(tm.w_base == -0.7) and torch.all(cm.mix_k == 0.5)
    assert 0 <= tm.mix_base.min() and tm.mix_base.max() < 1
    assert tm.mix_lora_a.std() < 0.02
    copy = tt.compute_copy(cfg, p)
    assert copy.layers[0] is p.layers[0]
    assert copy.lm_head.dtype == torch.bfloat16


def test_full_width_config_is_rwkv6_3b():
    cfg = get_arch(ARCH)
    tt.check_supported(cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim,
            cfg.d_ff, cfg.vocab, cfg.pos_emb, cfg.compute_dtype) == (
                32, 2560, 40, 64, 8960, 65536, "none", "bfloat16")
    assert tt.layer_kinds(cfg) == ["rwkv"] * 32
    assert cfg.d_model // cfg.rwkv_head_dim == cfg.n_heads
    assert cfg.rwkv_head_dim in kernel.HEAD_DIMS
