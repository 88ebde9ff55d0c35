"""The CUDA soc_step kernels (episode and serve, healthy and faulted; the
episode and serve kernels' MLP instantiations), the flash-attention kernel (K3),
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
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_probe
from repro_torch.kernels.moe_gmm.ref import gmm_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_ref
from repro_torch.kernels.rwkv6_scan import coverage as rw_cov
from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel
from repro_torch.kernels.rwkv6_scan import ops as rw_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv_ref
from repro_torch.kernels.soc_step import coverage, ops, ref
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


def _coverage_vs_ref(c, *, ddr=False, gated=False, mlp=None, qfun=None):
    """One launch of the episode kernel on a ``coverage.coverage_case``
    against ``ref.episode_ref`` on the CPU: every output bitwise equal."""
    cpu = lambda t: t.cpu()
    kw = dict(ddr_attribution=ddr, gated=gated)
    if mlp is not None:
        out = ops.fused_episode(c.static, c.learned, c.weights, c.qtable0,
                                c.extrema0, c.xs, qfun=qfun, mlp=mlp, **kw)
        kw.update(wpack0=cpu(mlp.wpack), qfun=cpu(qfun), mlp_lr=cpu(mlp.lr),
                  mlp_dims=socnn.mlp_dims(mlp.cfg),
                  mlp_feats=mlp.cfg.features)
    else:
        out = ops.fused_episode(c.static, c.learned, c.weights, c.qtable0,
                                c.extrema0, c.xs, **kw)
    torch.cuda.synchronize()
    want = ref.episode_ref(
        c.static, cpu(c.learned), rewards.RewardWeights(*map(cpu, c.weights)),
        cpu(c.qtable0), cpu(c.extrema0),
        ref.StepInputs(*(None if v is None else cpu(v) for v in c.xs)), **kw)
    for a, r in zip(out[:-1], want[:-1]):
        assert torch.equal(a.cpu(), r)
    for name, a, r in zip(ref.YCOLS, out[-1], want[-1]):
        assert torch.equal(a.cpu(), r), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", (1, 2, 4, 16))
@pytest.mark.parametrize("T", (1, 7, 16, 31, 32, 33, 64))
def test_cuda_episode_bitwise_over_the_grid(T, n_tiles):
    """K1 and K1f bitwise at every slot and tile count the kernel takes:
    one slot, a lane's two slots past 32, one and 16 tiles; learned and
    manual episodes, ddr and gated on and off, healthy and faulted."""
    _need_card()
    for faulted, combos in ((False, ((False, False), (True, True))),
                            (True, ((True, False), (False, True)))):
        c = coverage.coverage_case(T, n_tiles, 37, B=3, seed=T * 97 + n_tiles,
                                   faulted=faulted, device="cuda")
        for ddr, gated in combos:
            _coverage_vs_ref(c, ddr=ddr, gated=gated)


@pytest.mark.cuda
@pytest.mark.parametrize("S", (1, 2, 31, 33, 64, 65))
def test_cuda_episode_bitwise_at_ring_edges(S):
    """S = 1 and S around one and two ring chunks of 32 steps."""
    _need_card()
    for faulted in (False, True):
        c = coverage.coverage_case(12, 2, S, B=3, seed=S, faulted=faulted,
                                   device="cuda")
        _coverage_vs_ref(c, ddr=True, gated=True)
        _coverage_vs_ref(c)


@pytest.mark.cuda
@pytest.mark.parametrize("faulted", (False, True))
@pytest.mark.parametrize("feats,hidden", [("sense", (16, 16)),
                                          ("onehot", (16, 16)),
                                          ("onehot", ())])
def test_cuda_mlp_episode_bitwise(feats, hidden, faulted):
    """K1m and K1m faulted bitwise for both embeddings, a network episode
    (qfun 1) beside a table episode through the same launch (qfun 0),
    gated and not, at slot and tile counts past the paths'."""
    _need_card()
    keys = prng.PRNGKey(np.arange(3), device="cuda")
    mlp = socnn.init_mlp_qstate(keys, socnn.MLPConfig(features=feats,
                                                      hidden=hidden))
    qfun = torch.tensor([True, False, True], device="cuda")
    for T, n_tiles, gated in ((12, 2, False), (33, 4, True), (7, 16, False)):
        c = coverage.coverage_case(T, n_tiles, 45, B=3, seed=T + n_tiles,
                                   faulted=faulted, device="cuda")
        _coverage_vs_ref(c, gated=gated, mlp=mlp, qfun=qfun)


@pytest.mark.cuda
def test_cuda_fast_division_is_ieee_where_trusted():
    """The episode step's branch-free division equals IEEE division
    bitwise wherever its range flag trusts it, and flags exactly the pairs
    outside [2^-60, 2^60) (which the kernel recomputes with IEEE
    division)."""
    _need_card()
    from repro_torch.kernels.soc_step import kernel
    a, b, ok = kernel.qdiv_probe_inputs(1 << 20, seed=1)
    q, qok = kernel.qdiv_probe(torch.from_numpy(a).cuda(),
                               torch.from_numpy(b).cuda())
    assert np.array_equal(qok.cpu().numpy(), ok)
    want = (a / b).view(np.int32)
    assert np.array_equal(q.cpu().numpy().view(np.int32)[ok], want[ok])


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
        carry0.map(cpu),
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
    for name in ref.ServeCarry._fields[:-1]:    # a table carry: no wpack
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


def _mlp_serve_case(rate, device, intensity=None):
    """Four streams on SoC1 facing one bursty stream: a learning sense
    network, its frozen copy, a Q-table and fixed NON_COH with
    placeholder networks (``attach_placeholder_mlp``)."""
    soc = SOCS["SoC1"]
    env = vecenv.VecEnv(soc, seed=1, device=device)
    app = vecenv.compile_app(make_application(soc, seed=50, n_phases=2),
                             soc, seed=4)
    sched = app.schedule.to(device)
    mlp = socnn.init_mlp_qstate(prng.PRNGKey(7, device=device))
    specs = vecenv.stack_specs([
        vecenv.mlp_policy_spec(mlp, sched),
        vecenv.mlp_policy_spec(socnn.freeze(mlp), sched),
        vecenv.attach_placeholder_mlp(vecenv.learned_policy_spec(
            qlearn.init_qstate(device=device), sched)),
        vecenv.attach_placeholder_mlp(
            vecenv.fixed_policy_spec(env.params, sched, 0))])
    tspec = traffic.bursty(rate, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                           priority=(1.0, 0.25), backoff=400.0,
                           overload_frac=0.35, prio_reserve=0.25, seed=3,
                           device=device)
    cfg = qlearn.QConfig(decay_steps=200)
    arr = traffic.sample_arrivals(tspec, 160, sched.acc_id.shape[0])
    keys = prng.PRNGKey(np.arange(4), device=device)
    fs = (None if intensity is None else
          faults.storm(160, intensity, prng.PRNGKey(42), device=device))
    xs = vecenv.serve_inputs(env.params, sched, specs, arr, keys, fs)
    qs0 = specs.qstate
    step0, frozen = vecenv.merged_agent(specs)
    carry0 = ref.init_serve_carry(
        qs0.qtable, rewards.init_reward_state(soc.n_accs, (4,),
                                              device).extrema,
        soc.n_accs, soc.n_mem_tiles, 4, step0, specs.mlp.wpack)
    sp = vecenv.serve_params(cfg, frozen, tspec)
    rows = [v.expand(4, -1) for v in (arr.t_arr, arr.deadline,
                                      arr.priority)]
    return env.static, specs, sp, carry0, xs, rows


@pytest.mark.cuda
@pytest.mark.parametrize("rate,intensity", [(2e-7, None), (4e-3, None),
                                            (4e-3, 0.7)])
def test_cuda_mlp_serve_kernel_bitwise(rate, intensity):
    """K2m (K2m-faulted under a storm) in two chained launches, bitwise
    equal to ``ref.serve_episode_ref`` on the CPU: every trace column and
    every carry leaf, the trained packs included."""
    _need_card()
    s, specs, sp, carry0, xs, rows = _mlp_serve_case(rate, "cuda",
                                                     intensity)
    w = rewards.PAPER_DEFAULT_WEIGHTS
    kw = dict(qfun=specs.qfun, mlp=specs.mlp)
    ops.reset_launches()
    h = 80
    c1, y1 = ops.fused_serve_episode(
        s, specs.learned, w, sp, carry0, _slice(xs, slice(None, h)),
        *(r[:, :h] for r in rows), **kw)
    kc, ky2 = ops.fused_serve_episode(
        s, specs.learned, w, sp, c1, _slice(xs, slice(h, None)),
        *(r[:, h:] for r in rows), **kw)
    torch.cuda.synchronize()
    counts = (ops.mlp_serve_launches, ops.mlp_fault_serve_launches,
              ops.serve_launches, ops.fault_serve_launches)
    assert counts == ((0, 2, 0, 0) if intensity else (2, 0, 0, 0))
    cpu = lambda t: t.cpu()
    rc, ry = ref.serve_episode_ref(
        s, cpu(specs.learned), w, ref.ServeParams(*map(cpu, sp)),
        carry0.map(cpu),
        ref.StepInputs(*(None if v is None else cpu(v) for v in xs)),
        *map(cpu, rows), qfun=cpu(specs.qfun), mlp_lr=cpu(specs.mlp.lr),
        mlp_dims=socnn.mlp_dims(specs.mlp.cfg))
    assert torch.equal(torch.cat([y1, ky2], 1).cpu(), ry)
    for name in ref.ServeCarry._fields:
        assert torch.equal(getattr(kc, name).cpu(), getattr(rc, name)), name
    assert not torch.equal(kc.wpack[0], carry0.wpack[0])
    assert torch.equal(kc.wpack[1], carry0.wpack[1])
    if rate > 1e-3:
        assert ry[..., 10].max() == 1.0   # the watchdog tripped


@pytest.mark.cuda
@pytest.mark.parametrize("faulted", [False, True])
def test_cuda_serve_kernel_bitwise_on_the_edge_grid(faulted):
    """K2 / K2f on ``coverage.serve_edge_case`` (a full queue under a
    priority reserve, retries, deadline misses, a watchdog that trips and
    releases), in one launch and in two chained ones, bitwise equal to
    ``ref.serve_episode_ref`` on the CPU."""
    _need_card()
    c = coverage.serve_edge_case(seed=3, faulted=faulted, device="cuda")
    cpu = lambda t: t.cpu()
    rc, ry = ref.serve_episode_ref(
        c.static, cpu(c.learned), rewards.RewardWeights(
            *map(cpu, c.weights)), ref.ServeParams(*map(cpu, c.sp)),
        c.carry0.map(cpu),
        ref.StepInputs(*(None if v is None else cpu(v) for v in c.xs)),
        cpu(c.t_arr), cpu(c.deadline), cpu(c.priority))
    h = c.t_arr.shape[1] // 3
    runs = []
    for cuts in ((0, None), (0, h, None)):
        carry, ys = c.carry0, []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            sl = slice(lo, hi)
            carry, y = ops.fused_serve_episode(
                c.static, c.learned, c.weights, c.sp, carry, _slice(c.xs, sl),
                c.t_arr[:, sl], c.deadline[:, sl], c.priority[:, sl])
            ys.append(y)
        runs.append((carry, torch.cat(ys, 1)))
    for carry, y in runs:
        assert torch.equal(y.cpu(), ry)
        for name in ref.ServeCarry._fields[:-1]:   # no wpack
            assert torch.equal(getattr(carry, name).cpu(),
                               getattr(rc, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("net", coverage.SERVE_MLP_NETS)
def test_cuda_mlp_serve_kernel_bitwise_on_the_edge_grid(net, faulted):
    """K2m / K2m-faulted (a step warp and a network warp a stream) on
    ``coverage.serve_mlp_edge_case``: a learning network, its frozen copy,
    a table and NON_COH beside placeholders, a +inf Q-value, a watchdog
    that trips and releases, at the paths' sense network (the register
    path), the one-hot network and the widest one (shared memory); in one
    launch and in three chained ones, every trace column and carry leaf,
    the packs included, bitwise equal to ``ref.serve_episode_ref`` on the
    CPU."""
    _need_card()
    mc = coverage.serve_mlp_edge_case(net, seed=3, faulted=faulted,
                                      device="cuda")
    c = mc.case
    cpu = lambda t: t.cpu()
    rc, ry = ref.serve_episode_ref(
        c.static, cpu(c.learned), rewards.RewardWeights(
            *map(cpu, c.weights)), ref.ServeParams(*map(cpu, c.sp)),
        c.carry0.map(cpu),
        ref.StepInputs(*(None if v is None else cpu(v) for v in c.xs)),
        cpu(c.t_arr), cpu(c.deadline), cpu(c.priority),
        qfun=cpu(mc.qfun), mlp_lr=cpu(mc.mlp.lr),
        mlp_dims=socnn.mlp_dims(mc.mlp.cfg), mlp_feats=mc.mlp.cfg.features)
    n = c.t_arr.shape[1]
    ops.reset_launches()
    for cuts in ((0, n), (0, n // 3, 2 * n // 3, n)):
        carry, ys = c.carry0, []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            sl = slice(lo, hi)
            carry, y = ops.fused_serve_episode(
                c.static, c.learned, c.weights, c.sp, carry, _slice(c.xs, sl),
                c.t_arr[:, sl], c.deadline[:, sl], c.priority[:, sl],
                qfun=mc.qfun, mlp=mc.mlp)
            ys.append(y)
        assert torch.equal(torch.cat(ys, 1).cpu(), ry)
        for name in ref.ServeCarry._fields:
            assert torch.equal(getattr(carry, name).cpu(),
                               getattr(rc, name)), name
    torch.cuda.synchronize()
    assert (ops.mlp_fault_serve_launches if faulted
            else ops.mlp_serve_launches) == 4


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


@pytest.mark.cuda
@pytest.mark.parametrize("k,t,state", rw_cov.probe_cases())
def test_cuda_rwkv6_scan_coverage_probe(k, t, state):
    """K5's coverage probe (logw = 0, small integer r, k, v, u and s0:
    every sum exact) bitwise equal to ``ref.wkv_ref`` at every head dim,
    at one, two, three and 128 chunks, from a zero and a random-integer
    state."""
    _need_card()
    args = rw_cov.probe_inputs(2, 3, t, k, state=state, device="cuda")
    y, s_fin = rw_ops.rwkv6_scan(*args)
    y_want, s_want = wkv_ref(*args)
    assert torch.equal(y, y_want) and torch.equal(s_fin, s_want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
def test_cuda_rwkv6_scan_unaligned_rows(k):
    """Rows that do not start on 16 bytes (a view one float into its
    storage) take the kernel's 4-byte copies: the same result as the
    aligned copy of the same inputs, bitwise."""
    _need_card()
    b, h, t = 2, 3, 48
    rng = np.random.default_rng(1)
    n = b * h * t * k
    def shifted():
        flat = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32))
        return flat.to("cuda")[1:].view(b, h, t, k)
    r, kk, v = shifted(), shifted(), shifted()
    logw = torch.clamp(-torch.exp(0.5 * shifted()), min=-4.0)
    u = torch.from_numpy(rng.normal(size=(h, k)).astype(np.float32)).cuda()
    assert r.data_ptr() % 16 != 0
    got = rw_kernel.rwkv6_scan(r, kk, v, logw, u)
    want = rw_kernel.rwkv6_scan(*(x.clone() for x in (r, kk, v, logw)), u)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


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
    by_body = dict(gmm_ops.body_launches)
    got = gmm_ops.moe_gmm(x, w, sizes)
    torch.cuda.synchronize()
    assert gmm_ops.launches == before + 1 and got.dtype == dtype
    body = gmm_kernel.plan(x.shape, w.shape, dtype).body
    assert gmm_ops.body_launches[body] == by_body[body] + 1
    tol = (dict(rtol=5e-2, atol=5e-1) if dtype == torch.bfloat16 else TOL)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               gmm_ref(x, w, sizes).float().cpu().numpy(),
                               **tol)
    past = torch.arange(c, device="cuda") >= sizes[..., None]
    assert bool((got[past] == 0).all())


# (E, C, D, F), lead, dtype, body: every body of K4 at the granite serving
# path's prefill gate/up and down and decode gate/up and down shapes, and
# at ragged edges (C, F and D no tile divides; one row a group; 8 D slices
# of 520 rows, each staged in two pieces; 45 live rows an expert, in 6
# chunks)
GMM_PROBES = [
    ((48, 432, 1536, 512), (4,), torch.bfloat16, "tc_gmm"),
    ((48, 432, 512, 1536), (4,), torch.bfloat16, "tc_gmm"),
    ((4, 64, 128, 96), (), torch.bfloat16, "tc_gmm"),
    ((6, 300, 200, 40), (2,), torch.bfloat16, "tc_gmm"),
    ((3, 17, 8, 136), (1,), torch.bfloat16, "tc_gmm"),
    ((48, 8, 1536, 512), (4,), torch.bfloat16, "gemv_decode"),
    ((48, 8, 512, 1536), (4,), torch.bfloat16, "gemv_decode"),
    ((6, 16, 32, 24), (3,), torch.bfloat16, "gemv_decode"),
    ((5, 1, 2056, 72), (2,), torch.bfloat16, "gemv_decode"),
    ((7, 5, 4104, 8), (9,), torch.bfloat16, "gemv_decode"),
    ((5, 3, 17, 9), (2,), torch.bfloat16, "fp32_tiled"),
    ((48, 8, 64, 32), (4,), torch.float32, "fp32_tiled"),
    ((6, 432, 96, 40), (2,), torch.float32, "fp32_tiled"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lead,dtype,body", GMM_PROBES)
def test_cuda_moe_gmm_coverage_probe(shape, lead, dtype, body):
    """Each body of K4 drops no k tile, shifts no row or column at a tile
    edge, takes each group's expert (g % E) and zeroes every row past its
    group's size: the coverage probe (``ref.probe_inputs``: one or two 1s
    a row of x, small integer weights) is exact, atol 0, with the sizes
    cycling through 0, 1, 63-65, 127-129, C - 1, C, > C and -3."""
    _need_card()
    e, c, d, f = shape
    x, w, sizes = gmm_probe.probe_inputs(lead, e, c, d, f, dtype, "cuda")
    out, plan = gmm_kernel.launch(x, w, sizes)
    torch.cuda.synchronize()
    assert plan.body == body
    want = gmm_probe.probe_expected(lead, e, c, d, f, "cuda")
    assert out.dtype == dtype and torch.equal(out.float(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lead,dtype,body", GMM_PROBES)
def test_cuda_moe_gmm_launches_bitwise_equal(shape, lead, dtype, body):
    """Two launches of a body on the same random inputs are bitwise equal
    (gemv_decode adds its D slices' partials in rank order, without
    atomics), and within the reference's tolerance of the plain version."""
    _need_card()
    e, c, d, f = shape
    rng = np.random.default_rng(1)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
    x, w = mk(*lead, e, c, d), mk(e, d, f)
    sizes = torch.from_numpy(rng.integers(-1, c + 2, (*lead, e)).astype(
        np.int32)).to("cuda")
    got, plan = gmm_kernel.launch(x, w, sizes)
    again = gmm_kernel.moe_gmm(x, w, sizes)
    torch.cuda.synchronize()
    assert plan.body == body and torch.equal(got, again)
    tol = (dict(rtol=5e-2, atol=5e-1) if dtype == torch.bfloat16 else TOL)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               gmm_ref(x, w, sizes).float().cpu().numpy(),
                               **tol)


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
