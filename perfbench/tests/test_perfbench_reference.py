"""The benchmark's frozen reference against the port's plain versions at
a small size on the CPU: the same records, schedules, keys, lowered
manual policy and step loop.  (The test imports the port; the
reference does not.)"""
import dataclasses

import pytest
import torch

from perfbench import inputs
from perfbench.reference import apps as rapps, episodes as rep
from perfbench.reference import prng as rprng, qlearn as rq
from perfbench.reference import rewards as rr, step as rstep
from repro_torch import random as pprng
from repro_torch.kernels.soc_step import ref as pstep
from repro_torch.soc import apps as papps
from repro_torch.soc import vecenv as pvec

CONFIG = inputs.load_json("configs", "table4-qtable")
LANES = inputs.lanes(CONFIG)
PICK = {"SoC1": 2, "SoC3": 4, "SoC5": 6}


def _lane(name):
    lane = LANES[PICK[name]]
    return lane, inputs.port_soc(lane["soc"])


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None:
            assert y is None
        else:
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2147483671, 2**33 + 1])
def test_threefry(seed):
    k = torch.tensor([seed >> 32, seed & 0xFFFFFFFF])
    assert torch.equal(rprng.split(k, 5), pprng.split(k, 5))
    assert torch.equal(rprng.fold_in(k, 9), pprng.fold_in(k, 9))
    assert torch.equal(rprng.uniform(k, (64,)), pprng.uniform(k, (64,)))
    assert torch.equal(rprng.gumbel(k, (8, 4)), pprng.gumbel(k, (8, 4)))


@pytest.mark.parametrize("name", sorted(PICK))
def test_applications_and_schedules(name):
    lane, psoc = _lane(name)
    for spec in ({"seed": 0, "n_phases": 3},
                 {"seed": 50, "n_phases": 2, "case_study": [name]}):
        app = inputs.make_app(lane["soc"], spec)
        papp = (papps.make_case_study_app(psoc, seed=50) if "case_study"
                in spec else papps.make_application(psoc, seed=0,
                                                    n_phases=3))
        assert dataclasses.asdict(inputs.port_app(app)) == \
            dataclasses.asdict(papp)
        ref, port = rep.compile_app(app, lane["soc"], seed=3), \
            pvec.compile_app(papp, psoc, seed=3)
        _equal(ref.schedule, port.schedule)
        params = rep.lane_params(lane["soc"], 1, lane["flavor"])
        env = pvec.VecEnv(psoc, seed=1, flavor=lane["flavor"], device="cpu")
        _equal(params[:2], env.params[:2])
        assert tuple(params.static) == tuple(env.static)
        _equal(rep.precompute_manual_modes(params, ref.schedule)[None],
               pvec.precompute_manual_modes(env.params, port.schedule)[None])


@pytest.mark.parametrize("lane", range(len(LANES)))
def test_episode_loop(lane):
    lane = LANES[lane]
    soc = lane["soc"]
    params = rep.lane_params(soc, 1, lane["flavor"])
    sched = rep.compile_app(rapps.make_application(soc, seed=4, n_phases=2),
                            soc, seed=1).schedule
    q = rq.init_qstate_batch(rq.QConfig(), 3)
    spec = rep.learned_policy_spec(q, sched)
    keys = rprng.split(rprng.PRNGKey(11), 3)
    cfg = rq.QConfig(decay_steps=50)
    xs, _ = rep.episode_inputs(params, sched, spec, cfg, keys, gated=True)
    ext = rr.init_reward_state(soc.n_accs, (3,)).extrema
    w = rr.RewardWeights(0.5, 0.25, 0.25)
    ref = rstep.episode_ref(params.static, True, w, q.qtable, ext, xs,
                            gated=True)
    port = pstep.episode_ref(params.static, True, w, q.qtable, ext,
                             pstep.StepInputs(*xs), gated=True)
    _equal(ref[0][None], port[0][None])
    _equal(ref[1], port[1])


@pytest.mark.parametrize("lane", range(len(LANES)))
def test_app_counts_match_the_compiled_schedule(lane):
    """The rate's work and the roofline's shapes, counted from the
    application records, are the reference's compiled steps and slots."""
    soc = LANES[lane]["soc"]
    for spec in ({"seed": 0, "n_phases": 8},
                 {"seed": 50, "n_phases": 8,
                  "case_study": ["SoC4", "SoC5", "SoC6"]}):
        app = inputs.make_app(soc, spec)
        c = rep.compile_app(app, soc, seed=4)
        assert inputs.app_steps(app) == c.n_steps
        assert inputs.app_threads(app) == c.n_threads
