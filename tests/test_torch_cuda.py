"""The CUDA soc_step kernels (episode and serve, healthy and faulted; the
episode kernel's MLP instantiations), the flash-attention kernel (K3),
the RWKV-6 scan kernel (K5), the grouped expert-matmul kernel (K4) and
the RG-LRU scan kernel (K6) against their plain PyTorch versions, on the
card.

Imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Skips when ``torch.cuda.is_available()`` is false.  Integer traces must
be equal and floats within rtol = atol = 2e-5 (measured on an H100 at the
main path's shapes: bitwise equal).
"""
import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.core import qlearn, rewards
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ref import gmm_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_ref
from repro_torch.kernels.rwkv6_scan import ops as rw_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv_ref
from repro_torch.kernels.soc_step import ops, ref
from repro_torch.soc import faults, nn as socnn, traffic, vecenv
from repro_torch.soc.apps import make_application, make_phase
from repro_torch.soc.config import SOC_MOTIV_PAR, SOCS
from repro_torch.soc.des import Application

TOL = dict(rtol=2e-5, atol=2e-5)
COMBOS = [(False, False, True), (True, True, True), (False, False, False)]


def _case(learned: bool, device):
    soc = SOC_MOTIV_PAR
    env = vecenv.VecEnv(soc, seed=1, device=device)
    rng = np.random.default_rng(3)
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=4,
                         size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M", "L"))]
    compiled = vecenv.compile_app(
        Application(name="cuda-kernel-test", phases=phases), soc, seed=7)
    sched = compiled.schedule.to(device)
    b, n = 6, compiled.n_steps
    cfg = qlearn.QConfig(decay_steps=n)
    if learned:
        spec = vecenv.learned_policy_spec(
            qlearn.init_qstate_batch(cfg, b, device), sched)
    else:
        m = vecenv.manual_policy_spec(env.params, sched)
        spec = vecenv.PolicySpec(
            modes=m.modes.expand(b, n),
            learned=torch.zeros(b, dtype=torch.bool, device=device),
            qstate=qlearn.QState(*(v.expand(b, *v.shape[1:])
                                   for v in m.qstate)))
    keys = prng.PRNGKey(np.arange(b), device=device)
    w = rewards.stack_weights(
        [(0.675, 0.075, 0.25), (0.125, 0.125, 0.75), (1.0, 0.0, 0.0),
         (0.0, 0.0, 1.0), (0.4, 0.4, 0.2), (0.33, 0.33, 0.34)],
        device=device)
    return env, sched, spec, cfg, keys, w


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


def _slice(xs, sl):
    return ref.StepInputs(*(None if v is None else v[:, sl] for v in xs))


def _check_episode(ddr, gated, learned, intensity=None):
    """One launch of the episode kernel (faulted under a storm of
    ``intensity``) against ``ref.episode_ref`` on the CPU."""
    env, sched, spec, cfg, keys, w = _case(learned, "cuda")
    fs = (None if intensity is None else faults.storm(
        sched.acc_id.shape[0], intensity, prng.PRNGKey(42), device="cuda"))
    xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys,
                                  gated=gated, faults=fs)
    b = keys.shape[0]
    ex0 = rewards.init_reward_state(SOC_MOTIV_PAR.n_accs, (b,),
                                    "cuda").extrema
    q0 = spec.qstate.qtable.contiguous()
    ops.reset_launches()
    kq, kys = ops.fused_episode(env.static, spec.learned, w, q0, ex0, xs,
                                ddr_attribution=ddr, gated=gated)
    torch.cuda.synchronize()
    counts = (ops.launches, ops.fault_launches)
    assert counts == ((0, 1) if fs is not None else (1, 0))
    cpu = lambda t: t.cpu()
    rq, rys = ref.episode_ref(
        env.static, cpu(spec.learned),
        rewards.RewardWeights(*map(cpu, w)), cpu(q0), cpu(ex0),
        ref.StepInputs(*(None if v is None else cpu(v) for v in xs)),
        ddr_attribution=ddr, gated=gated)
    np.testing.assert_allclose(kq.cpu().numpy(), rq.numpy(), **TOL)
    for name, a, c in zip(ref.YCOLS, kys, rys):
        a, c = a.cpu().numpy(), c.numpy()
        if np.issubdtype(c.dtype, np.integer):
            np.testing.assert_array_equal(a, c, err_msg=name)
        else:
            np.testing.assert_allclose(a, c, err_msg=name, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("ddr,gated,learned", COMBOS)
def test_cuda_kernel_matches_ref(ddr, gated, learned):
    _need_card()
    _check_episode(ddr, gated, learned)


@pytest.mark.cuda
@pytest.mark.parametrize("ddr,gated,learned", COMBOS)
def test_cuda_faulted_kernel_matches_ref(ddr, gated, learned):
    """The faulted instantiation (K1f) under the severe storm."""
    _need_card()
    _check_episode(ddr, gated, learned, intensity=1.0)


@pytest.mark.cuda
def test_cuda_faulted_zero_spec_is_healthy():
    """A zero spec through K1f equals the healthy kernel, bitwise."""
    _need_card()
    env, sched, spec, cfg, keys, w = _case(True, "cuda")
    b = keys.shape[0]
    ex0 = rewards.init_reward_state(SOC_MOTIV_PAR.n_accs, (b,),
                                    "cuda").extrema
    outs = []
    for fs in (None, faults.no_faults(device="cuda")):
        xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys,
                                      faults=fs)
        q, ys = ops.fused_episode(env.static, spec.learned, w,
                                  spec.qstate.qtable.contiguous(), ex0, xs)
        outs.append((q, *ys))
    for a, c in zip(*outs):
        assert torch.equal(a, c)


def _check_mlp_episode(spec, env, sched, cfg, keys, w, intensity=None,
                       gated=False):
    """One launch of the MLP instantiation (faulted under a storm of
    ``intensity``) against ``ref.episode_ref``'s MLP branch on the CPU;
    returns the kernel's ``(qtable, wpack, ys)``."""
    fs = (None if intensity is None else faults.storm(
        sched.acc_id.shape[0], intensity, prng.PRNGKey(42), device="cuda"))
    xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys,
                                  gated=gated, faults=fs)
    b = keys.shape[0]
    ex0 = rewards.init_reward_state(SOC_MOTIV_PAR.n_accs, (b,),
                                    "cuda").extrema
    q0 = spec.qstate.qtable.contiguous()
    mlp = spec.mlp
    ops.reset_launches()
    kq, kw, kys = ops.fused_episode(env.static, spec.learned, w, q0, ex0, xs,
                                    gated=gated, qfun=spec.qfun, mlp=mlp)
    torch.cuda.synchronize()
    assert (ops.launches, ops.fault_launches, ops.mlp_launches,
            ops.mlp_fault_launches) == ((0, 0, 0, 1) if fs is not None
                                        else (0, 0, 1, 0))
    cpu = lambda t: t.cpu()
    rq, rw, rys = ref.episode_ref(
        env.static, cpu(spec.learned),
        rewards.RewardWeights(*map(cpu, w)), cpu(q0), cpu(ex0),
        ref.StepInputs(*(None if v is None else cpu(v) for v in xs)),
        gated=gated, wpack0=cpu(mlp.wpack), qfun=cpu(spec.qfun),
        mlp_lr=cpu(mlp.lr), mlp_dims=socnn.mlp_dims(mlp.cfg),
        mlp_feats=mlp.cfg.features)
    np.testing.assert_allclose(kq.cpu().numpy(), rq.numpy(), **TOL)
    np.testing.assert_allclose(kw.cpu().numpy(), rw.numpy(), **TOL)
    for name, a, c in zip(ref.YCOLS, kys, rys):
        a, c = a.cpu().numpy(), c.numpy()
        if np.issubdtype(c.dtype, np.integer):
            np.testing.assert_array_equal(a, c, err_msg=name)
        else:
            np.testing.assert_allclose(a, c, err_msg=name, **TOL)
    return kq, kw, kys


@pytest.mark.cuda
@pytest.mark.parametrize("intensity,gated", [(None, False), (None, True),
                                             (1.0, False)])
def test_cuda_mlp_kernel_matches_ref(intensity, gated):
    """K1m learning with the default sense network (and, under the severe
    storm, its faulted instantiation): traces, table and trained pack."""
    _need_card()
    env, sched, _, cfg, keys, w = _case(True, "cuda")
    spec = vecenv.mlp_policy_spec(socnn.init_mlp_qstate(keys), sched)
    _, kw, _ = _check_mlp_episode(spec, env, sched, cfg, keys, w, intensity,
                                  gated)
    assert not torch.equal(kw, spec.mlp.wpack)


@pytest.mark.cuda
def test_cuda_onehot_mlp_selects_table_modes():
    """A frozen ``mlp_from_qtable`` network through K1m selects exactly
    the modes K1 selects from the same frozen table, and equals its plain
    version."""
    _need_card()
    env, sched, spec, cfg, keys, w = _case(True, "cuda")
    b = keys.shape[0]
    ex0 = rewards.init_reward_state(SOC_MOTIV_PAR.n_accs, (b,),
                                    "cuda").extrema
    xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys)
    trained, _ = ops.fused_episode(env.static, spec.learned, w,
                                   spec.qstate.qtable.contiguous(), ex0, xs)
    qs = qlearn.freeze(spec.qstate._replace(qtable=trained))
    tspec = vecenv.learned_policy_spec(qs, sched)
    xs, _ = vecenv.episode_inputs(env.params, sched, tspec, cfg, keys)
    _, tys = ops.fused_episode(env.static, tspec.learned, w,
                               qs.qtable.contiguous(), ex0, xs)
    mspec = vecenv.mlp_policy_spec(socnn.freeze(socnn.mlp_from_qtable(
        qs.qtable)), sched)
    _, kw, kys = _check_mlp_episode(mspec, env, sched, cfg, keys, w)
    for a, c in zip(kys[:3], tys[:3]):
        assert torch.equal(a, c)
    assert torch.equal(kw, mspec.mlp.wpack)


@pytest.mark.cuda
def test_cuda_placeholder_mlp_is_the_table_kernel():
    """A table spec given the placeholder network runs K1m and returns
    K1's results bitwise, the placeholder untouched."""
    _need_card()
    env, sched, spec, cfg, keys, w = _case(True, "cuda")
    ph = vecenv.attach_placeholder_mlp(spec)
    b = keys.shape[0]
    ex0 = rewards.init_reward_state(SOC_MOTIV_PAR.n_accs, (b,),
                                    "cuda").extrema
    xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys)
    xs_ph, _ = vecenv.episode_inputs(env.params, sched, ph, cfg, keys)
    for a, c in zip(xs, xs_ph):
        assert a is None or torch.equal(a, c)
    q0 = spec.qstate.qtable.contiguous()
    tq, tys = ops.fused_episode(env.static, spec.learned, w, q0, ex0, xs)
    mq, mw, mys = ops.fused_episode(env.static, ph.learned, w, q0, ex0, xs,
                                    qfun=ph.qfun, mlp=ph.mlp)
    assert torch.equal(tq, mq) and torch.equal(mw, ph.mlp.wpack)
    for a, c in zip(tys, mys):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_wrapper_checks_inputs():
    _need_card()
    from repro_torch.kernels.soc_step import kernel
    env, sched, spec, cfg, keys, w = _case(True, "cuda")
    xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys)
    xf, xi = ref.pack_inputs(xs)
    b = keys.shape[0]
    consts = ref.pack_consts(env.static, spec.learned, w, b, "cuda")
    ex0 = rewards.init_reward_state(12, (b,), "cuda").extrema
    q0 = spec.qstate.qtable.contiguous()
    kw = dict(n_threads=xs.others.shape[-1], n_tiles=2, n_actions=4)
    with pytest.raises(TypeError):
        kernel.soc_step_episode(xf.double(), xi, consts, q0, ex0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.soc_step_episode(xf.transpose(0, 1), xi, consts, q0, ex0,
                                **kw)
    bad = xi.clone()
    bad[0, 0, 0] = 12
    with pytest.raises(ValueError, match="column 0"):
        kernel.soc_step_episode(xf, bad, consts, q0, ex0, **kw)


def _serve_case(rate, device, intensity=None):
    """Three streams (a learning agent, fixed NON_COH, manual) on SoC1
    facing one two-tenant bursty stream; ``rate`` 4e-3 overloads it and
    trips the watchdog.  ``intensity`` adds a fault storm."""
    soc = SOCS["SoC1"]
    env = vecenv.VecEnv(soc, seed=1, device=device)
    app = vecenv.compile_app(make_application(soc, seed=50, n_phases=2),
                             soc, seed=4)
    sched = app.schedule.to(device)
    specs = vecenv.stack_specs([
        vecenv.learned_policy_spec(qlearn.init_qstate(device=device), sched),
        vecenv.fixed_policy_spec(env.params, sched, 0),
        vecenv.manual_policy_spec(env.params, sched)])
    tspec = traffic.bursty(rate, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                           priority=(1.0, 0.25), backoff=400.0,
                           overload_frac=0.35, prio_reserve=0.25, seed=3,
                           device=device)
    cfg = qlearn.QConfig(decay_steps=200)
    arr = traffic.sample_arrivals(tspec, 160, sched.acc_id.shape[0])
    keys = prng.PRNGKey(np.arange(3), device=device)
    fs = (None if intensity is None else
          faults.storm(160, intensity, prng.PRNGKey(42), device=device))
    xs = vecenv.serve_inputs(env.params, sched, specs, arr, keys, fs)
    qs0 = specs.qstate
    carry0 = ref.init_serve_carry(
        qs0.qtable, rewards.init_reward_state(soc.n_accs, (3,),
                                              device).extrema,
        soc.n_accs, soc.n_mem_tiles, 4, qs0.step)
    sp = vecenv.serve_params(cfg, qs0.frozen, tspec)
    rows = [v.expand(3, -1) for v in (arr.t_arr, arr.deadline,
                                      arr.priority)]
    return env.static, specs.learned, sp, carry0, xs, rows


def _check_serve(rate, intensity=None):
    """Two chained launches of the serve kernel (faulted under a storm of
    ``intensity``) against ``ref.serve_episode_ref`` on the CPU."""
    s, learned, sp, carry0, xs, rows = _serve_case(rate, "cuda", intensity)
    w = rewards.PAPER_DEFAULT_WEIGHTS
    ops.reset_launches()
    h = 80
    c1, y1 = ops.fused_serve_episode(
        s, learned, w, sp, carry0, _slice(xs, slice(None, h)),
        *(r[:, :h] for r in rows))
    kc, ky2 = ops.fused_serve_episode(
        s, learned, w, sp, c1, _slice(xs, slice(h, None)),
        *(r[:, h:] for r in rows))
    torch.cuda.synchronize()
    counts = (ops.serve_launches, ops.fault_serve_launches)
    assert counts == ((0, 2) if intensity is not None else (2, 0))
    ky = torch.cat([y1, ky2], 1).cpu().numpy()
    cpu = lambda t: t.cpu()
    rc, ry = ref.serve_episode_ref(
        s, cpu(learned), w, ref.ServeParams(*map(cpu, sp)),
        ref.ServeCarry(*map(cpu, carry0)),
        ref.StepInputs(*(None if v is None else cpu(v) for v in xs)),
        *map(cpu, rows))
    ry = ry.numpy()
    for c, name in enumerate(ref.SERVE_YCOLS):
        if name in ("mode", "state_idx", "action", "executed", "retries",
                    "depth", "degraded"):
            np.testing.assert_array_equal(ky[..., c], ry[..., c],
                                          err_msg=name)
        else:
            np.testing.assert_allclose(ky[..., c], ry[..., c], err_msg=name,
                                       **TOL)
    for name in ref.ServeCarry._fields:
        np.testing.assert_allclose(getattr(kc, name).cpu().numpy(),
                                   getattr(rc, name).numpy(), err_msg=name,
                                   **TOL)
    if rate > 1e-3:
        assert ry[..., 10].max() == 1.0   # the watchdog tripped


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [2e-7, 4e-3])
def test_cuda_serve_kernel_matches_ref(rate):
    _need_card()
    _check_serve(rate)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [2e-7, 4e-3])
def test_cuda_faulted_serve_kernel_matches_ref(rate):
    """The faulted instantiation (K2f) under storm 0.7."""
    _need_card()
    _check_serve(rate, intensity=0.7)


# ------------------------------------------------------- flash attention
FA_SHAPES = [
    # (B, H, Hkv, Sq, Skv, hd): tests/test_kernels.py's shapes, decode
    # rows, a Gemma-2-sized head, head dim 16 and ragged tails
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 64),
    (1, 4, 1, 256, 256, 128), (1, 2, 2, 128, 384, 64),
    (2, 8, 2, 1, 1, 64), (2, 8, 2, 1, 37, 64), (2, 8, 2, 1, 129, 64),
    (1, 4, 2, 96, 300, 256), (2, 4, 4, 33, 70, 16), (1, 2, 1, 5, 5, 32)]
FA_FEATS = [dict(causal=True), dict(causal=True, window=64),
            dict(causal=True, softcap=50.0), dict(causal=False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FA_SHAPES)
@pytest.mark.parametrize("feat", FA_FEATS)
def test_cuda_flash_attention_matches_plain(shape, dtype, feat):
    """K3 against ``ref.attention_ref`` on the same inputs, at the
    reference's tolerances (2e-5 in float32, 2e-2 in bfloat16)."""
    _need_card()
    b, h, hkv, sq, skv, hd = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to("cuda", dtype) for s in ((b, sq, h, hd), (b, skv, hkv, hd),
                                            (b, skv, hkv, hd)))
    before = fa_ops.launches
    body = fa_kernel.plan(q.shape, k.shape, dtype,
                          window=feat.get("window", 0)).body
    by_body = fa_ops.body_launches[body]
    got = fa_ops.flash_attention(q, k, v, **feat)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert fa_ops.body_launches[body] == by_body + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), **feat).transpose(1, 2)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


# (B, H, Hkv, Sq, Skv, hd), type, window, soft-cap, body: every body at
# head dims 64 / 128 / 256, rows not a multiple of the tile, Sq < Skv,
# windows and soft-caps, decode over long rows and short prompts
FA_BODY_CASES = [
    ((2, 8, 2, 128, 128, 64), torch.bfloat16, 0, 0.0, "tc_prefill"),
    ((1, 4, 1, 200, 333, 128), torch.bfloat16, 0, 0.0, "tc_prefill"),
    ((1, 4, 2, 96, 300, 256), torch.bfloat16, 100, 30.0, "tc_prefill"),
    ((2, 6, 2, 130, 500, 64), torch.bfloat16, 64, 0.0, "tc_prefill"),
    ((1, 8, 8, 257, 257, 128), torch.bfloat16, 0, 50.0, "tc_prefill"),
    ((2, 32, 8, 1, 2049, 128), torch.bfloat16, 0, 0.0, "split_decode"),
    ((2, 16, 1, 1, 700, 256), torch.bfloat16, 0, 0.0, "split_decode"),
    ((2, 24, 8, 1, 2049, 64), torch.bfloat16, 0, 0.0, "split_decode"),
    ((1, 16, 1, 4, 300, 256), torch.bfloat16, 0, 50.0, "split_decode"),
    ((1, 12, 4, 7, 500, 64), torch.bfloat16, 200, 0.0, "split_decode"),
    ((2, 4, 4, 33, 70, 16), torch.bfloat16, 0, 0.0, "split_decode"),
    ((2, 32, 8, 1, 2049, 128), torch.float32, 0, 0.0, "split_decode"),
    ((1, 16, 1, 3, 300, 256), torch.float32, 100, 30.0, "split_decode"),
    ((1, 4, 2, 96, 300, 256), torch.float32, 0, 0.0, "fp32_prefill"),
    ((2, 4, 4, 128, 128, 16), torch.bfloat16, 0, 0.0, "fp32_prefill"),
    ((1, 13, 1, 5, 300, 64), torch.bfloat16, 0, 0.0, "fp32_prefill"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_BODY_CASES,
                         ids=lambda c: f"{c[4]}-{c[0]}-{c[1]}-w{c[2]}-"
                                       f"cap{c[3]}")
def test_cuda_flash_attention_body_matches_plain(case):
    """Each body (the plan names it) against ``ref.attention_ref`` at the
    reference's tolerances, and two launches bitwise equal."""
    _need_card()
    shape, dtype, window, softcap, body = case
    b, h, hkv, sq, skv, hd = shape
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to("cuda", dtype) for s in ((b, sq, h, hd), (b, skv, hkv, hd),
                                            (b, skv, hkv, hd)))
    feat = dict(causal=True, window=window, softcap=softcap)
    got, plan = fa_kernel.launch(q, k, v, **feat)
    again = fa_kernel.flash_attention(q, k, v, **feat)
    torch.cuda.synchronize()
    assert plan.body == body
    assert torch.equal(got, again)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), **feat).transpose(1, 2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", [
    ((1, 4, 4, 128, 128, 64), 0), ((2, 8, 2, 200, 333, 128), 0),
    ((1, 4, 1, 96, 300, 256), 0), ((1, 2, 2, 256, 256, 128), 64),
    ((2, 6, 2, 130, 500, 64), 100), ((1, 4, 2, 300, 300, 256), 129)])
def test_cuda_flash_attention_coverage_probe(shape, window):
    """The tensor-core prefill drops no key and adds none: with q = 0 and
    a one-hot v, out is > 0 exactly where a row sees the column's probe
    key, and within 1% of 1 / n_visible there, for probe keys swept over
    every key (tile edges, the diagonal and the window's edge among them).
    bf16's 2e-2 against random inputs cannot show one key missing."""
    _need_card()
    b, h, hkv, sq, skv, hd = shape
    feat = dict(causal=True, window=window)
    for sweep in range(-(-skv // (b * hkv * hd))):
        keys = fa_ref.probe_keys(b, hkv, hd, skv, sweep, device="cuda")
        q, k, v = fa_ref.probe_inputs(b, h, hkv, sq, skv, hd, keys,
                                      torch.bfloat16, "cuda", seed=sweep)
        out, plan = fa_kernel.launch(q, k, v, **feat)
        assert plan.body == "tc_prefill"
        want = fa_ref.probe_expected(keys, sq, skv, h, **feat)
        assert fa_ref.probe_faults(out, want) == 0


# (B, H, Hkv, Sq, Skv, hd), window: the split decode at head dims 64 /
# 128 / 256 with 1, 4 and 7 query rows (Sq x group <= 64), Skv 2049 (a
# last split of one key), short rings and a window that starts the keys
FA_DECODE_PROBES = [
    ((2, 32, 8, sq, 2049, 128), 0) for sq in (1, 4, 7)] + [
    ((2, 24, 8, sq, 2049, 64), 0) for sq in (1, 4, 7)] + [
    ((2, 16, 1, 1, 700, 256), 0), ((2, 16, 1, 4, 2048, 256), 0),
    ((1, 16, 8, 1, 1100, 256), 1000), ((1, 16, 8, 7, 1100, 256), 1000),
    ((1, 12, 4, 5, 333, 64), 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", FA_DECODE_PROBES)
def test_cuda_flash_attention_decode_coverage_probe(shape, window):
    """The bf16 split decode (on the tensor cores at these head dims) drops
    no key and adds none: the coverage probe above over every key, k and
    v read as a cache slice whose later rows hold v = 1.  And with q four
    times larger, so each query head's softmax peaks on its own keys, it
    gives each row its own head's and query row's output (a row mapped to
    another would miss by ~1, past bf16's 2e-2)."""
    _need_card()
    b, h, hkv, sq, skv, hd = shape
    feat = dict(causal=True, window=window)
    for sweep in range(-(-skv // (b * hkv * hd))):
        keys = fa_ref.probe_keys(b, hkv, hd, skv, sweep, device="cuda")
        q, k, v = fa_ref.probe_inputs(b, h, hkv, sq, skv, hd, keys,
                                      torch.bfloat16, "cuda", seed=sweep)
        kc = torch.randn((b, skv + 31, hkv, hd), device="cuda").to(k.dtype)
        vc = torch.ones_like(kc)
        kc[:, :skv], vc[:, :skv] = k, v
        out, plan = fa_kernel.launch(q, kc[:, :skv], vc[:, :skv], **feat)
        assert plan.body == "split_decode"
        want = fa_ref.probe_expected(keys, sq, skv, h, **feat)
        assert fa_ref.probe_faults(out, want) == 0
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to("cuda", torch.bfloat16)
               for s in ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    q = (4 * q.float()).to(torch.bfloat16)
    got = fa_kernel.flash_attention(q, k, v, **feat)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), **feat).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


# ----------------------------------------------------------- rwkv6 scan
@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 32, 16), (2, 4, 64, 32),
                                   (1, 1, 128, 64), (2, 3, 48, 64)])
def test_cuda_rwkv6_scan_matches_plain(shape, state):
    """K5 against ``ref.wkv_ref`` on the same inputs (rtol = atol = 2e-5),
    from a zero or a random state, with r, k, v and logw read in place
    from the models' (B, T, H, K) layout."""
    _need_card()
    b, h, t, k = shape
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to("cuda")
    r, kk, v = (mk(b, t, h, k).transpose(1, 2) for _ in range(3))
    logw = torch.clamp(-torch.exp(0.5 * mk(b, t, h, k)), min=-4.0) \
        .transpose(1, 2)
    u = mk(h, k)
    s0 = mk(b, h, k, k) if state else torch.zeros((b, h, k, k),
                                                  device="cuda")
    before = rw_ops.launches
    y, s_fin = rw_ops.rwkv6_scan(r, kk, v, logw, u, s0 if state else None)
    torch.cuda.synchronize()
    assert rw_ops.launches == before + 1
    y_want, s_want = wkv_ref(r, kk, v, logw, u, s0)
    assert y.shape == (b, h, t, k) and s_fin.shape == (b, h, k, k)
    for got, want in ((y, y_want), (s_fin, s_want)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)


# ------------------------------------------------------ grouped matmul
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,lead", [
    ((4, 64, 128, 96), ()), ((8, 32, 64, 64), ()), ((2, 128, 256, 128), ()),
    ((6, 432, 96, 40), (2,)), ((48, 8, 64, 32), (4,)), ((5, 3, 17, 9), (2,))])
def test_cuda_moe_gmm_matches_plain(shape, lead, dtype):
    """K4 against ``ref.gmm_ref`` on the same inputs (float32 at rtol =
    atol = 2e-5, bf16 at ``tests/test_kernels.py``'s 5e-2 / 5e-1), at the
    reference's test shapes and batched ones (a prefill-like capacity, a
    decode-like 8 rows, ragged edges), rows past each size exactly 0."""
    _need_card()
    e, c, d, f = shape
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
    x, w = mk(*lead, e, c, d), mk(e, d, f)
    sizes = torch.from_numpy(rng.integers(0, c + 1, (*lead, e)).astype(
        np.int32)).to("cuda")
    before = gmm_ops.launches
    got = gmm_ops.moe_gmm(x, w, sizes)
    torch.cuda.synchronize()
    assert gmm_ops.launches == before + 1 and got.dtype == dtype
    tol = (dict(rtol=5e-2, atol=5e-1) if dtype == torch.bfloat16 else TOL)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               gmm_ref(x, w, sizes).float().cpu().numpy(),
                               **tol)
    past = torch.arange(c, device="cuda") >= sizes[..., None]
    assert bool((got[past] == 0).all())


# ------------------------------------------------------------ rglru scan
@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 32), (1, 256, 64), (3, 64, 16),
                                   (2, 37, 100), (1, 1, 5)])
def test_cuda_rglru_scan_matches_plain(shape, state):
    """K6 against ``ref.rglru_ref`` on the same inputs (rtol = atol = 1e-5,
    ``tests/test_kernels.py``'s), at the reference test's shapes and at
    lengths and widths no chunk or block divides, from a zero or a random
    ``h0`` (folded into the first step by ``ops``)."""
    _need_card()
    b, t, w = shape
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to("cuda")
    log_a, bb = -torch.exp(mk(b, t, w)), mk(b, t, w)
    h0 = mk(b, w) if state else None
    before = rg_ops.launches
    y, h_fin = rg_ops.rglru_scan(log_a, bb, h0)
    torch.cuda.synchronize()
    assert rg_ops.launches == before + 1
    y_want, h_want = rglru_ref(log_a, bb, torch.zeros((b, w), device="cuda")
                               if h0 is None else h0)
    assert y.shape == (b, t, w) and h_fin.shape == (b, w)
    for got, want in ((y, y_want), (h_fin, h_want)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
