"""Gemma-2 serving in the port against the reference, on the CPU: the
smoke configurations of gemma2-9b and gemma2-27b (4 layers alternating
local (window 8) and global attention, d_model 64, 4 heads over 2 kv
heads of 16, GeLU, the embedding scale, attention soft-cap 50, final
soft-cap 30, post-attention and post-MLP RMSNorms, a tied head), with the
reference's own weights (``init_params(cfg, PRNGKey(0))``) carried across
by ``repro_torch.models.convert``, every norm weight (zero in the
reference's init) set from a seed so the post-norms' scales count.

A 16-token prompt (past the window, so the local layers' rings wrap) and
8 greedy decode steps: float32 logits within 1e-5 absolute (measured on
the CPU: 1.9e-6), every greedy token equal.  In bfloat16 both packages
decode the reference's tokens: logits within 2e-2 (measured 9.8e-3), and
the port's greedy token equal wherever the reference's two best logits
lie more than twice the bound apart (at decode step 5 they tie exactly in
bfloat16, and the two packages break the tie apart).
``params_from_numpy`` and ``params_to_numpy`` carry the post-norms both
ways bit for bit.
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
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import convert, transformer as tt

F32_TOL = 1e-5
BF16_TOL = 2e-2
PROMPT, GEN, BATCH, MAX_LEN = 16, 8, 2, 24
ARCHS = ("gemma2-9b", "gemma2-27b")
NORMS = ("ln1", "ln2", "post_ln1", "post_ln2", "final_norm")


def _cfgs(arch, dtype="float32"):
    return (j_smoke(arch).replace(compute_dtype=dtype),
            smoke_config(arch).replace(compute_dtype=dtype))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _set_norms(tree, rng):
    """Every norm weight of the tree drawn from ``rng``."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                    if k in NORMS else _set_norms(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, _ = _cfgs(arch)
    tree = _set_norms(_np(jt.init_params(jcfg, jax.random.PRNGKey(0))),
                      np.random.default_rng(1))
    return arch, tree


def _prompt(cfg):
    return host_batch(cfg, DataConfig(PROMPT, BATCH, seed=0), 0)["tokens"]


def _as_dicts(tree):
    """The reference tree with its named tuples as dicts, numpy leaves."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return np.asarray(tree)


def _run_both(arch, tree, dtype):
    """Prefill and GEN greedy decode steps through both packages; returns
    per step (reference logits, port logits).  In float32 each package
    decodes its own greedy tokens, checked equal step by step; in
    bfloat16 both decode the reference's."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.params_from_numpy(cfg, tree)
    toks = _prompt(cfg)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, max_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    out = [(np.asarray(jl), tl.float().numpy())]
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(GEN):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        else:
            ttok = torch.from_numpy(np.array(jtok))
        jc, jl = dec(jp, jc, {"tokens": jtok}, jnp.int32(PROMPT + i))
        tc, tl = tt.decode_step(cfg, tp, tc, {"tokens": ttok}, PROMPT + i)
        out.append((np.asarray(jl), tl.float().numpy()))
    return out


def test_params_round_trip_carry_the_post_norms(setup):
    arch, tree = setup
    _, cfg = _cfgs(arch)
    tp = convert.params_from_numpy(cfg, tree)
    assert all(l.post_ln1 is not None and l.post_ln2 is not None
               for l in tp.layers)
    names = {n for n, _ in tp.named_parameters()}
    assert {"layers.0.post_ln1", "layers.3.post_ln2"} <= names
    back = convert.params_to_numpy(cfg, tp)
    want = jax.tree_util.tree_leaves_with_path(_as_dicts(tree))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_and_decode_match_reference(setup, dtype, tol):
    """Every step's logits within the bound (inside the final soft-cap's
    +-30) and the greedy tokens equal (in bfloat16 where the reference's
    best logit leads by more than twice the bound)."""
    arch, tree = setup
    for want, got in _run_both(arch, tree, dtype):
        assert got.shape == want.shape == (BATCH, 1, 128)
        assert np.abs(got).max() <= 30.0
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        top2 = np.sort(want, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * tol
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


def test_final_softcap_applies_in_float32():
    """``lm_logits`` caps the float32 logits: 30 tanh(x / 30)."""
    _, cfg = _cfgs("gemma2-9b", "bfloat16")
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    h = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16) * 40
    got = tt.lm_logits(cfg, p, h)
    raw = tt.lm_logits(cfg.replace(final_softcap=0.0), p, h)
    assert got.dtype == torch.float32
    assert torch.equal(got, 30.0 * torch.tanh(raw / 30.0))


def test_serve_matches_reference(setup):
    """``serve`` on the CPU against the reference's ``serve``: every
    generated token equal (both from the reference's own weights)."""
    arch, _ = setup
    jcfg, cfg = _cfgs(arch)
    want = j_serve.serve(jcfg, BATCH, PROMPT, GEN, seed=0)
    ref = _np(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    got = t_serve.serve(cfg, BATCH, PROMPT, GEN, seed=0, device="cpu",
                        params=convert.params_from_numpy(cfg, ref))
    np.testing.assert_array_equal(got["generated"], want["generated"])
