"""The port's LM serving path (``repro_torch.models``,
``repro_torch.launch.serve``) against the reference's on Qwen3-8B's smoke
configuration (2 layers, d_model 64, 4 heads, 2 kv heads, head dim 16,
vocab 128), with the reference's own weights (``init_params(cfg,
PRNGKey(0))``) carried across by ``repro_torch.models.convert``.

Tolerances: float32 logits and caches within 1e-5 absolute (measured on
the CPU: 1.1e-6 for the logits, 1.4e-6 for the caches; the gap is the
order of summation in the matmuls and XLA's own sin/cos), every greedy
token equal; bfloat16 logits within 2e-2 (measured 1.6e-2: the
reference rounds the softmax probabilities to bfloat16 before ``p @ v``,
the kernel path keeps them in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import DataConfig, host_batch
from repro.launch import serve as j_serve
from repro.models import transformer as jt
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import convert, transformer as tt

F32_TOL = 1e-5
BF16_TOL = 2e-2
PROMPT, GEN, BATCH, MAX_LEN = 16, 8, 2, 24


def _cfgs(dtype="float32"):
    return (j_smoke("qwen3-8b").replace(compute_dtype=dtype),
            smoke_config("qwen3-8b").replace(compute_dtype=dtype))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    return jt.init_params(jcfg, jax.random.PRNGKey(0))


def _prompt(cfg):
    return host_batch(cfg, DataConfig(PROMPT, BATCH, seed=0), 0)["tokens"]


def _run_both(dtype, ref_params, steps=GEN):
    """Prefill and ``steps`` greedy decode steps through both packages;
    returns per step (reference logits, port logits) and the two final
    caches."""
    jcfg, cfg = _cfgs(dtype)
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    toks = _prompt(cfg)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, max_len=MAX_LEN))(
        ref_params, {"tokens": jnp.asarray(toks)})
    tc, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    out = [(np.asarray(jl), tl.numpy())]
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(steps):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jc, jl = dec(ref_params, jc, {"tokens": jtok}, jnp.int32(PROMPT + i))
        tc, tl = tt.decode_step(cfg, tp, tc, {"tokens": ttok}, PROMPT + i)
        out.append((np.asarray(jl), tl.numpy()))
    return out, jc, tc


def _cache_err(cfg, jc, tc):
    want = convert.cache_from_numpy(cfg, _np(jc))
    assert len(want) == len(tc) == cfg.n_layers
    return max((a.float() - b.float()).abs().max().item()
               for pw, pt in zip(want, tc) for a, b in zip(pw, pt))


def _as_dicts(tree):
    """The reference tree with its named tuples as dicts, numpy leaves."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_params_round_trip(ref_params):
    """Reference tree -> port modules -> reference tree, bit for bit."""
    _, cfg = _cfgs()
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    assert len(tp.layers) == cfg.n_layers
    assert tp.layers[1].attn.wq.shape == (64, 4, 16)
    want = jax.tree_util.tree_leaves_with_path(_as_dicts(ref_params))
    got = jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(cfg, tp))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    again = convert.params_from_numpy(cfg, convert.params_to_numpy(cfg, tp))
    for (n1, a), (n2, b) in zip(tp.named_parameters(),
                                again.named_parameters()):
        assert n1 == n2 and torch.equal(a, b)


def test_parameter_names_follow_the_reference_tree():
    _, cfg = _cfgs()
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    names = {n for n, _ in p.named_parameters()}
    for n in ("embed", "lm_head", "final_norm", "layers.0.ln1",
              "layers.1.ln2", "layers.0.attn.wq", "layers.0.attn.k_norm",
              "layers.1.mlp.w_gate", "layers.1.mlp.w_down"):
        assert n in names, n
    assert all(t.dtype == torch.float32 for t in p.parameters())


def test_prefill_matches_reference(ref_params):
    """Last-token logits and the whole K/V cache."""
    out, jc, tc = _run_both("float32", ref_params, steps=0)
    want, got = out[0]
    assert got.shape == want.shape == (BATCH, 1, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _cache_err(_cfgs()[1], jc, tc) <= F32_TOL


def test_decode_steps_match_reference(ref_params):
    """Eight greedy decode steps: logits within the bound, every token
    equal (checked step by step inside ``_run_both``), caches too."""
    out, jc, tc = _run_both("float32", ref_params)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _cache_err(_cfgs()[1], jc, tc) <= F32_TOL


def test_bf16_matches_reference(ref_params):
    out, _, _ = _run_both("bfloat16", ref_params)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def test_decode_from_reference_cache(ref_params):
    """One decode step from the reference's prefill cache carried
    across."""
    jcfg, cfg = _cfgs()
    toks = _prompt(cfg)
    jc, jl = jt.prefill(jcfg, ref_params, {"tokens": jnp.asarray(toks)},
                        max_len=MAX_LEN)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    tc = convert.cache_from_numpy(cfg, _np(jc))
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    jc2, jl2 = jt.decode_step(jcfg, ref_params, jc, {"tokens": tok},
                              jnp.int32(PROMPT))
    tc2, tl2 = tt.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
        np.array(tok))}, PROMPT)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=F32_TOL)
    assert _cache_err(cfg, jc2, tc2) <= F32_TOL


def test_serve_matches_reference(ref_params):
    """``serve`` on the CPU against the reference's ``serve`` on the same
    prompts and weights: every generated token equal."""
    jcfg, cfg = _cfgs()
    want = j_serve.serve(jcfg, BATCH, PROMPT, GEN, seed=0)
    got = t_serve.serve(cfg, BATCH, PROMPT, GEN, seed=0, device="cpu",
                        params=convert.params_from_numpy(cfg,
                                                         _np(ref_params)))
    assert got["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["logits"].shape == (BATCH, GEN, 128)
    np.testing.assert_array_equal(
        got["logits"].argmax(-1).numpy(), got["generated"])
    for k in ("prefill_s", "decode_s", "decode_tok_per_s"):
        assert got[k] > 0


def test_compute_copy_computes_the_same_numbers():
    """The bfloat16 matmul weights cast once give the logits that casting
    the float32 weights at every use gives, bit for bit."""
    _, cfg = _cfgs("bfloat16")
    p = tt.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = {"tokens": torch.from_numpy(_prompt(cfg))}
    copy = tt.compute_copy(cfg, p)
    assert copy.layers[0].mlp.w_up.dtype == torch.bfloat16
    assert copy.layers[0].ln1.dtype == torch.float32
    c1, l1 = tt.prefill(cfg, p, toks, max_len=MAX_LEN)
    c2, l2 = tt.prefill(cfg, copy, toks, max_len=MAX_LEN)
    assert torch.equal(l1, l2)
    tok = torch.argmax(l1, -1).to(torch.int32)
    _, d1 = tt.decode_step(cfg, p, c1, {"tokens": tok}, PROMPT)
    _, d2 = tt.decode_step(cfg, copy, c2, {"tokens": tok}, PROMPT)
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("arch", ["gemma2-9b", "arctic-480b",
                                  "qwen2-vl-2b", "musicgen-large"])
def test_unported_features_raise(arch):
    """No feature of these configs is left unported any more: each one's
    smoke config (gemma2-9b's with the int8 KV cache) builds its
    parameters and passes ``check_supported``, which now raises only for
    configs no model runs (``tests/test_torch_lm_configs.py`` serves them
    against the reference)."""
    cfg = smoke_config(arch)
    if arch == "gemma2-9b":
        cfg = cfg.replace(kv_cache_dtype="int8")
    tt.check_supported(cfg)
    tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tt.check_supported(cfg.replace(kv_cache_dtype="fp8"))


def test_int8_cache_raises():
    """The int8 cache is ported: ``init_cache`` makes each attention
    layer's entries (int8 zeros, float32 unit scales), as the reference's
    ``_init_layer_cache``; an unknown cache type raises."""
    cfg = smoke_config("qwen3-8b").replace(kv_cache_dtype="int8")
    cache = tt.init_cache(cfg, 1, 8, "cpu")
    (kq, ks), (vq, vs) = cache[0]
    assert kq.dtype == vq.dtype == torch.int8 and kq.shape == (1, 8, 2, 16)
    assert ks.dtype == torch.float32 and ks.shape == (1, 8, 2, 1)
    assert bool((ks == 1).all()) and not bool(kq.any())
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tt.init_cache(cfg.replace(kv_cache_dtype="fp8"), 1, 8, "cpu")


def test_full_width_config_is_qwen3_8b():
    cfg = get_arch("qwen3-8b")
    tt.check_supported(cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.compute_dtype) == (
                36, 4096, 32, 8, 128, "bfloat16")
    assert cfg.param_count() == 8_190_431_232
