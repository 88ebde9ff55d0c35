"""The CUDA soc_step kernel against its plain PyTorch version, on the card.

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
from repro_torch.kernels.soc_step import ops, ref
from repro_torch.soc import vecenv
from repro_torch.soc.apps import make_phase
from repro_torch.soc.config import SOC_MOTIV_PAR
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


@pytest.mark.cuda
@pytest.mark.parametrize("ddr,gated,learned", COMBOS)
def test_cuda_kernel_matches_ref(ddr, gated, learned):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    env, sched, spec, cfg, keys, w = _case(learned, "cuda")
    xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys,
                                  gated=gated)
    b = keys.shape[0]
    ex0 = rewards.init_reward_state(SOC_MOTIV_PAR.n_accs, (b,),
                                    "cuda").extrema
    q0 = spec.qstate.qtable.contiguous()
    ops.reset_launches()
    kq, kys = ops.fused_episode(env.static, spec.learned, w, q0, ex0, xs,
                                ddr_attribution=ddr, gated=gated)
    torch.cuda.synchronize()
    assert ops.launches == 1
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
def test_cuda_wrapper_checks_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
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
