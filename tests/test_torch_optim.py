"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``).

Over a stacked smoke tree (the reference's ``init_params`` of Qwen3-8B's
and arctic-480b's smoke configs, two superblocks) and five steps of the
same seeded gradients, the port's tensors grouped as the reference's
stacked leaves (``convert.leaf_groups``): AdamW's parameters and moments
within 2e-6 of each leaf's largest magnitude (measured on the CPU: 6.7e-7;
the global norm's and the moments' float32 sums run in another order),
Adafactor's (the update clip and parameter scale over each whole stacked
leaf, factored at the default threshold and at 32) within 2e-6 (measured
2.5e-7), and the int8 error-feedback compressor (blocks cut from each
stacked leaf flattened, a layer's norm of 64 values sharing its blocks
with the next layer's): the jitted reference's quantized values and
dequantized gradients bitwise (its ``/ 127`` the float32 reciprocal's
product), the residuals within 1.2e-7 of the leaf's largest value (XLA's
fused multiply-add).  ``warmup_cosine`` within 2e-7 relative or 6e-8
absolute (measured 2.2e-8 near the end of the decay, where ``1 + cos``
cancels: XLA's cosine and torch's one float32 ulp apart, times 0.45).
Then the cases of ``tests/test_optim.py`` on the port (its hypothesis
property as a seeded loop).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import transformer as jt
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.optim import schedule as j_schedule
from repro_torch.configs import smoke_config
from repro_torch.models import convert
from repro_torch.optim import adafactor, adamw, compress, schedule

STEPS = 5
ADAM_TOL = 2e-6
ADAFACTOR_TOL = 2e-6
SCHEDULE_RTOL, SCHEDULE_ATOL = 2e-7, 6e-8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setting(arch):
    """(reference params, port named params, leaf groups, groups list)."""
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(cfg, _np(jp))
    groups = convert.leaf_groups(cfg, tp)
    named = {k: p.detach().clone() for k, p in tp.named_parameters()}
    return cfg, jp, named, groups


def _grads(jp, step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(rng.normal(size=p.shape) * scale, np.float32),
        jp)


def _port(cfg, groups, tree):
    return convert.named_from_tree(cfg, groups, convert.flat_tree(_np(tree)))


def _leaf_err(groups, ref_tree, named):
    """Largest error of each leaf over its largest magnitude."""
    want = convert.flat_tree(_np(ref_tree))
    got = convert.tree_from_named(groups, named)
    return max(float(np.abs(want[k] - got[k]).max())
               / max(float(np.abs(want[k]).max()), 1e-30)
               for k in want if want[k].size)


@pytest.mark.parametrize("arch", ["qwen3-8b", "arctic-480b"])
def test_adamw_matches_reference_on_stacked_tree(arch):
    cfg, jp, named, groups = _setting(arch)
    js = j_adamw.init(jp)
    ts = adamw.init(named)
    jupd = jax.jit(lambda g, s, p, lr: j_adamw.update(g, s, p, lr_scale=lr))
    leaves = list(groups.values())
    for step in range(STEPS):
        g = _grads(jp, step, scale=0.3)
        lr = j_schedule.warmup_cosine(js.step, warmup_steps=2,
                                      total_steps=STEPS)
        jp, js, jm = jupd(g, js, jp, lr)
        tlr = schedule.warmup_cosine(ts.step, warmup_steps=2,
                                     total_steps=STEPS)
        named, ts, tm = adamw.update(_port(cfg, groups, g), ts, named,
                                     lr_scale=tlr, leaves=leaves)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-6 * float(jm["grad_norm"]))
        assert int(ts.step) == int(js.step)
        for ref, got in ((jp, named), (js.mu, ts.mu), (js.nu, ts.nu)):
            err = _leaf_err(groups, ref, got)
            assert err <= ADAM_TOL, (step, err)


@pytest.mark.parametrize("factor_at", [128, 32])
def test_adafactor_matches_reference_whole_leaf_statistics(factor_at):
    cfg, jp, named, groups = _setting("arctic-480b")
    jcfg = j_adafactor.AdafactorConfig(min_dim_size_to_factor=factor_at)
    tcfg = adafactor.AdafactorConfig(min_dim_size_to_factor=factor_at)
    js = j_adafactor.init(jp, jcfg)
    ts = adafactor.init(named, tcfg)
    n_factored = sum(v.vc.numel() > 0 for v in ts.v.values())
    assert (n_factored > 0) == (factor_at == 32)
    jupd = jax.jit(lambda g, s, p: j_adafactor.update(g, s, p, jcfg))
    leaves = list(groups.values())
    for step in range(STEPS):
        # large enough that the update clip is active on some leaves
        g = _grads(jp, step, scale=10.0 ** (step - 2))
        jp, js, _ = jupd(g, js, jp)
        named, ts, _ = adafactor.update(_port(cfg, groups, g), ts, named,
                                        tcfg, leaves=leaves)
        err = _leaf_err(groups, jp, named)
        assert err <= ADAFACTOR_TOL, (step, err)
        vr = {k: s.vr for k, s in ts.v.items()}
        want_vr = jax.tree_util.tree_map(
            lambda s: s.vr, js.v,
            is_leaf=lambda x: isinstance(x, j_adafactor._LeafState))
        assert _leaf_err(groups, want_vr, vr) <= ADAFACTOR_TOL


def test_adafactor_whole_leaf_is_not_per_layer():
    """A statistic per layer would be another optimizer: the same update
    with every tensor its own leaf moves the parameters visibly."""
    cfg, jp, named, groups = _setting("arctic-480b")
    per_layer = {k: p.clone() for k, p in named.items()}
    g = _port(cfg, groups, _grads(jp, 0))
    adafactor.update(g, adafactor.init(named), named,
                     leaves=list(groups.values()))
    adafactor.update(g, adafactor.init(per_layer), per_layer)
    diff = max(float((named[k] - per_layer[k]).abs().max()) for k in named
               if named[k].numel())
    assert diff > 1e-6, diff     # float32 noise here is ~1e-8


def test_compression_matches_reference_blocks_over_stacked_leaf():
    """Each step from the reference's residuals: the compressed gradients
    bitwise, the new residuals ``g + r - deq`` within 1.2e-7 of the leaf's
    largest ``|g + r|`` (XLA contracts the subtraction with the
    dequantizing product into one fused multiply-add; ROADMAP C1)."""
    cfg, jp, named, groups = _setting("qwen3-8b")
    # a layer's norm (64 values) is not a multiple of 256: its blocks
    # span the two superblocks' norms
    ln = groups["blocks.l0_attn_global.ln1"]
    assert len(ln) == 2 and named[ln[0]].numel() % compress.BLOCK
    jef = j_compress.init_ef(jp)
    jcomp = jax.jit(j_compress.compress_grads)
    leaves = list(groups.values())
    for step in range(STEPS):
        g = _grads(jp, step, scale=0.01)
        tef = compress.EFState(_port(cfg, groups, jef.residual))
        total = convert.flat_tree(_np(jax.tree_util.tree_map(
            lambda a, b: a + b, g, jef.residual)))
        jg, jef = jcomp(g, jef)
        tg, tef = compress.compress_grads(_port(cfg, groups, g), tef, leaves)
        want, got = (convert.flat_tree(_np(jg)),
                     convert.tree_from_named(groups, tg))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        want = convert.flat_tree(_np(jef.residual))
        got = convert.tree_from_named(groups, tef.residual)
        for k in want:
            bound = 1.2e-7 * float(np.abs(total[k]).max(initial=0.0))
            assert float(np.abs(got[k] - want[k]).max(initial=0.0)) <= (
                bound), k


def test_quantize_matches_jitted_reference():
    rng = np.random.default_rng(3)
    for n in (1, 255, 256, 257, 777):
        x = np.asarray(rng.normal(size=(n,)) * 10.0 ** rng.uniform(-4, 3),
                       np.float32)
        jq, js = jax.jit(j_compress.quantize_int8)(jnp.asarray(x))
        tq, ts = compress.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_warmup_cosine_matches_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for warm, total in ((10, 100), (200, 10000), (1, 2), (0, 50)):
        want = np.asarray(jax.jit(lambda s: j_schedule.warmup_cosine(
            s, warmup_steps=warm, total_steps=total))(jnp.asarray(steps)))
        got = schedule.warmup_cosine(torch.from_numpy(steps),
                                     warmup_steps=warm,
                                     total_steps=total).numpy()
        np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL,
                                   atol=SCHEDULE_ATOL)
    assert float(schedule.constant(5, 0.5)) == 0.5


def test_global_norm_sums_leaves_in_reference_order():
    cfg, jp, named, groups = _setting("qwen3-8b")
    g = _grads(jp, 0)
    want = float(j_adamw.global_norm(g))
    got = float(adamw.global_norm(_port(cfg, groups, g),
                                  list(groups.values())))
    assert abs(got - want) <= 1e-6 * want


# ------------------------------------------- tests/test_optim.py's cases ---
def _quad_params():
    return {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor(4.0)}


def _quad_grads(p):
    p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = torch.sum(torch.square(p["w"])) + torch.square(p["b"])
    g = torch.autograd.grad(loss, list(p.values()))
    return dict(zip(p, g))


def _quad_loss(p):
    return float(torch.sum(torch.square(p["w"])) + torch.square(p["b"]))


def test_adamw_converges_quadratic():
    params = _quad_params()
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = adamw.init(params, cfg)
    for _ in range(300):
        params, state, _ = adamw.update(_quad_grads(params), state, params,
                                        cfg)
    assert _quad_loss(params) < 1e-3


def test_adafactor_converges_quadratic():
    params = {"w": torch.ones((4, 4)) * 3.0}
    cfg = adafactor.AdafactorConfig(lr=0.3, min_dim_size_to_factor=2)
    state = adafactor.init(params, cfg)
    for _ in range(300):
        grads = {"w": 2.0 * params["w"]}
        params, state, _ = adafactor.update(grads, state, params, cfg)
    assert float(torch.sum(torch.square(params["w"]))) < 1e-2


def test_adafactor_memory_is_factored():
    state = adafactor.init({"w": torch.zeros((512, 256))})
    n = sum(s.vr.numel() + s.vc.numel() for s in state.v.values())
    assert n <= 512 + 256 + 1, n


def test_adamw_clip_norm():
    grads = {"w": torch.full((10,), 1e6)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert float(norm) > 1e6
    assert abs(float(adamw.global_norm(clipped)) - 1.0) < 1e-4


def test_schedule_warmup_cosine():
    s = schedule.warmup_cosine(0, warmup_steps=10, total_steps=100)
    assert float(s) == 0.0
    s_w = schedule.warmup_cosine(10, warmup_steps=10, total_steps=100)
    assert abs(float(s_w) - 1.0) < 1e-6
    s_end = schedule.warmup_cosine(100, warmup_steps=10, total_steps=100,
                                   min_ratio=0.1)
    assert abs(float(s_end) - 0.1) < 1e-6


@pytest.mark.parametrize("seed", range(15))
def test_int8_roundtrip_error_bound(seed):
    """|x - deq(q(x))| <= half a step of the block's 127 levels."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-4, 3)
    x = torch.from_numpy(np.asarray(rng.normal(size=(777,)) * scale,
                                    np.float32))
    q, s = compress.quantize_int8(x)
    deq = compress.dequantize_int8(q, s, x.shape)
    pad = (-x.numel()) % compress.BLOCK
    blocks = np.pad(x.numpy(), (0, pad)).reshape(-1, compress.BLOCK)
    bound = np.abs(blocks).max(axis=1) / 127.0 * 0.5 + 1e-9
    err = np.pad(np.abs((deq - x).numpy()), (0, pad)).reshape(
        -1, compress.BLOCK)
    assert np.all(err.max(axis=1) <= bound * 1.01)


def test_error_feedback_unbiased_over_time():
    """The running sum of compressed gradients tracks the running sum of
    true ones within the last residual."""
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy(np.asarray(rng.normal(size=(300,)),
                                          np.float32)) * 0.01
              for _ in range(50)]
    ef = compress.init_ef({"g": g_true[0]})
    sum_c = torch.zeros(300)
    sum_t = torch.zeros(300)
    for g in g_true:
        cg, ef = compress.compress_grads({"g": g}, ef)
        sum_c += cg["g"]
        sum_t += g
    resid = float((sum_c - sum_t).abs().max())
    assert resid <= float(ef.residual["g"].abs().max()) + 1e-6


def test_compressed_training_still_converges():
    params = _quad_params()
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    state = adamw.init(params, cfg)
    ef = compress.init_ef(params)
    for _ in range(400):
        grads, ef = compress.compress_grads(_quad_grads(params), ef)
        params, state, _ = adamw.update(grads, state, params, cfg)
    assert _quad_loss(params) < 1e-2
