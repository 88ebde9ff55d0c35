"""The last four reference configs served by the port against the
reference, on the CPU: the smoke configurations of arctic-480b (the dense
residual MLP beside its 4-expert top-2 MoE), musicgen-large (sinusoidal
positions, GeLU, audio codebooks: K embeddings summed, K heads), qwen2-vl-2b
(M-RoPE over (4, 2, 2) rotary sections, the vision stub: 4 projected patch
embeddings of width 32 over the first positions) and yi-34b (plain GQA),
each 2 layers of d_model 64, 4 heads over 2 kv heads of 16 (musicgen's
full multi-head attention over 2), with the reference's own weights
(``init_params(cfg, PRNGKey(0))``) carried across by
``repro_torch.models.convert``.

A 16-token prompt (musicgen's (B, K, S) codebook ids; qwen2-vl's with the
pipeline's vision embeddings and M-RoPE positions, whose text starts at
the patch grid's side) and 8 greedy decode steps (qwen2-vl's at M-RoPE
position ``prompt + i`` on all three streams, as the reference's serve):
float32 logits within 1e-5 absolute (measured on the CPU: 1.2e-6 at most,
qwen2-vl's and yi's; 9.5e-7 musicgen's, 9.8e-7 arctic's), every greedy
token of every codebook equal, the caches within 1e-5 (measured 1.2e-6); ``serve`` generates the reference's tokens in its layout.
``params_from_numpy`` and ``params_to_numpy`` carry the new parameters
(arctic's ``mlp`` beside ``moe``, qwen2-vl's ``vision_proj``, musicgen's
(K, V, D) embeddings and (K, D, V) heads) both ways bit for bit.

The units: the codebook sum bitwise the reference's jitted here in both
of its orders (its prompt's Python ``sum`` and its decode's stacked
reduction, both left to right, K = 4); M-RoPE within 1e-6 of the
reference's (measured 2.4e-7) and the sinusoidal table within 1e-5 at
positions below 64 (measured 2.4e-7 at width 64, 3.8e-6 at musicgen's
2,048, where an ulp of XLA's folded exp in a frequency near 1 grows with
the position; XLA's sin, cos and exp differ from PyTorch's by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import DataConfig, host_batch
from repro.launch import serve as j_serve
from repro.models import common as jcommon, transformer as jt
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import common as tcommon, convert, transformer as tt

F32_TOL = 1e-5
PROMPT, GEN, BATCH, MAX_LEN = 16, 8, 2, 24
ARCHS = ("arctic-480b", "musicgen-large", "qwen2-vl-2b", "yi-34b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _as_dicts(tree):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = j_smoke(arch)
    return arch, jcfg, smoke_config(arch), _np(
        jt.init_params(jcfg, jax.random.PRNGKey(0)))


def _prompt(cfg):
    data = host_batch(cfg, DataConfig(PROMPT, BATCH, seed=0), 0)
    return {k: v for k, v in data.items() if k != "labels"}


def _step(cfg, tok, i):
    """A decode step's batch (qwen2-vl's with its M-RoPE positions)."""
    step = {"tokens": tok}
    if cfg.family == "vlm":
        step["mrope_positions"] = np.full((3, BATCH, 1), PROMPT + i,
                                          np.int32)
    return step


def _run_both(jcfg, cfg, tree):
    """Prefill and GEN greedy decode steps through both packages, each on
    its own greedy tokens (checked equal); returns per step (reference
    logits, port logits) and the two final caches."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.params_from_numpy(cfg, tree)
    prompt = _prompt(cfg)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, max_len=MAX_LEN))(
        jp, {k: jnp.asarray(v) for k, v in prompt.items()})
    tc, tl = tt.prefill(cfg, tp, {k: torch.from_numpy(np.array(v))
                                  for k, v in prompt.items()},
                        max_len=MAX_LEN)
    out = [(np.asarray(jl), tl.numpy())]
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(GEN):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jstep = {k: jnp.asarray(v) for k, v in _step(cfg, jtok, i).items()}
        tstep = {k: torch.as_tensor(np.asarray(v))
                 for k, v in _step(cfg, ttok, i).items()}
        jc, jl = dec(jp, jc, jstep, jnp.int32(PROMPT + i))
        tc, tl = tt.decode_step(cfg, tp, tc, tstep, PROMPT + i)
        out.append((np.asarray(jl), tl.numpy()))
    return out, jc, tc


def test_params_round_trip(setup):
    """Reference tree -> port modules -> reference tree, bit for bit, with
    each config's new parameters present."""
    arch, _, cfg, tree = setup
    tp = convert.params_from_numpy(cfg, tree)
    names = {n for n, _ in tp.named_parameters()}
    new = {"arctic-480b": {"layers.0.moe.w_up", "layers.0.mlp.w_up",
                           "layers.1.mlp.w_down"},
           "musicgen-large": {"embed", "lm_head"},
           "qwen2-vl-2b": {"vision_proj"},
           "yi-34b": {"layers.1.mlp.w_gate"}}[arch]
    assert new <= names
    if cfg.n_codebooks:
        assert tp.embed.shape == (2, 128, 64)
        assert tp.lm_head.shape == (2, 64, 128)
    want = jax.tree_util.tree_leaves_with_path(_as_dicts(tree))
    got = jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(cfg, tp))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_prefill_and_decode_match_reference(setup):
    """Every step's float32 logits within 1e-5, every greedy token equal,
    the final caches within 1e-5."""
    _, jcfg, cfg, tree = setup
    out, jc, tc = _run_both(jcfg, cfg, tree)
    shape = ((BATCH, cfg.n_codebooks, 1, 128) if cfg.n_codebooks
             else (BATCH, 1, 128))
    for want, got in out:
        assert got.shape == want.shape == shape
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    want = convert.cache_from_numpy(cfg, _np(jc))
    assert max((a - b).abs().max().item()
               for pw, pt in zip(want, tc) for a, b in zip(pw, pt)) <= F32_TOL


def test_serve_matches_reference(setup):
    """``serve`` on the CPU against the reference's ``serve`` from the
    reference's weights: every generated token equal, in its layout ((B,
    gen), or (gen, B, K, 1) with codebooks)."""
    _, jcfg, cfg, tree = setup
    want = j_serve.serve(jcfg, BATCH, PROMPT, GEN, seed=0)
    got = t_serve.serve(cfg, BATCH, PROMPT, GEN, seed=0, device="cpu",
                        params=convert.params_from_numpy(cfg, tree))
    assert got["generated"].shape == want["generated"].shape
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_codebook_sums_in_both_reference_orders():
    """K = 4 codebooks: the port's embedding equals the reference's
    prompt (Python ``sum``) and decode (stacked reduction) bitwise."""
    jcfg = j_smoke("musicgen-large").replace(n_codebooks=4)
    cfg = smoke_config("musicgen-large").replace(n_codebooks=4)
    rng = np.random.default_rng(0)
    embed = (rng.normal(size=(4, 128, 64))
             * 10.0 ** rng.integers(-3, 3, (4, 128, 64))).astype(np.float32)
    tokens = rng.integers(0, 128, (3, 4, 5)).astype(np.int32)
    tp = tt.Transformer([], torch.from_numpy(embed), None,
                        torch.zeros(64))
    pos = torch.zeros((1, 5), dtype=torch.long)
    got = tt.embed_tokens(cfg.replace(pos_emb="none"), tp,
                          torch.from_numpy(tokens), positions=pos).numpy()
    prompt = jax.jit(lambda e, t: jt.embed_tokens(
        jcfg.replace(pos_emb="none"), {"embed": e}, {"tokens": t}))(
            jnp.asarray(embed), jnp.asarray(tokens))
    decode = jax.jit(lambda e, t: jnp.stack(
        [e[k][t[:, k]] for k in range(4)]).sum(0))(jnp.asarray(embed),
                                                   jnp.asarray(tokens))
    np.testing.assert_array_equal(got, np.asarray(prompt))
    np.testing.assert_array_equal(got, np.asarray(decode))


def test_mrope_and_sinusoidal_units():
    """M-RoPE within 1e-6 of the reference's on random rows and positions
    (XLA's sin and cos lie an ulp from PyTorch's; measured 2.4e-7) and
    bitwise the port's own RoPE where the three streams agree; the
    sinusoidal table within 1e-5 at positions below 64 (measured 3.8e-6
    at width 2,048)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos3 = rng.integers(0, 40, (3, 2, 9)).astype(np.int32)
    want = jax.jit(lambda a, p: jcommon.apply_mrope(a, p, (4, 2, 2), 1e6))(
        jnp.asarray(x), jnp.asarray(pos3))
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              (4, 2, 2), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    same = torch.from_numpy(np.broadcast_to(pos3[:1], pos3.shape).copy())
    assert torch.equal(
        tcommon.apply_mrope(torch.from_numpy(x), same, (4, 2, 2), 1e6),
        tcommon.apply_rope(torch.from_numpy(x), same[0], 1e6))
    pos = np.arange(64)[None]
    for dim in (64, 2048):
        want = jax.jit(lambda p: jcommon.sinusoidal_pos_emb(p, dim))(
            jnp.asarray(pos))
        got = tcommon.sinusoidal_pos_emb(torch.from_numpy(pos), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
