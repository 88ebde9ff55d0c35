"""Training jobs of tabular agents on stacked SoC lanes: the window loop
around ``StackedVecEnv.train_batched``.

A job trains ``weights x seeds_per_weighting`` fresh agents on every
lane for ``iterations`` iterations (one training launch and one
evaluation launch an iteration, after one baseline launch), each job
with its own keys.  Its work is the valid accelerator invocations that
all its episodes simulate.  The check recomputes, for a sample of
agents of the last completed job, every launch with the reference
(:mod:`perfbench.reference.check`).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import check as rc
from perfbench.reference import episodes as ep
from perfbench.reference import qlearn as rq
from perfbench.reference import rewards as rr
from perfbench.reference import roofline
from perfbench.reference import step as ref_step
from perfbench.reference.modes import CoherenceMode

NAMES = ("step_ints", "step_floats", "agent_ints", "agent_floats",
         "history")
# exact decisions; float gaps between the sound runs' readings and the
# control's and faults' (PERF.md section 2 gives the readings)
LIMITS = {"step_ints": 0, "step_floats": 1e-4, "agent_ints": 0,
          "agent_floats": 1e-4, "history": 1e-4}


class State:
    pass


def lane_plan(run) -> list[dict]:
    """The cell's lanes, each with its SoC and applications: what the
    benchmark makes and hands to both sides."""
    tr = run.traffic
    lanes = inputs.lanes(run.config)
    if tr.get("lanes") is not None:
        lanes = [lanes[i] for i in tr["lanes"]]
    for lane in lanes:
        lane["train_app"] = inputs.make_app(lane["soc"], tr["train_app"])
        lane["eval_app"] = inputs.make_app(lane["soc"], tr["eval_app"])
    return lanes


def ref_plan(run, lanes):
    """The reference's own profiles and compiled schedules of each lane,
    worked out after the window (never in set-up)."""
    tr = run.traffic
    for lane in lanes:
        soc = lane["soc"]
        lane["params"] = ep.lane_params(soc, lane["profile_seed"],
                                        lane["flavor"])
        lane["train"] = [ep.compile_app(lane["train_app"], soc, seed=it)
                         for it in range(tr["iterations"])]
        lane["eval"] = ep.compile_app(lane["eval_app"], soc,
                                      seed=tr["eval_app"]["tile_seed"])


def launch_shape(lanes, app: str, episodes: int) -> roofline.LaunchShape:
    """One launch of ``app`` (``"train_app"`` or ``"eval_app"``) over the
    lanes, from the application records."""
    return roofline.LaunchShape(
        steps=[inputs.app_steps(l[app]) for l in lanes], episodes=episodes,
        n_tiles=[l["soc"].n_mem_tiles for l in lanes],
        n_threads=[inputs.app_threads(l[app]) for l in lanes],
        n_accs=[l["soc"].n_accs for l in lanes])


def qconfig(run, n_steps: int) -> dict:
    q = run.config["agent"]["qconfig"]
    return dict(q, decay_steps=int(n_steps) * run.config["agent"][
        "decay_iterations"])


def weight_rows(run) -> list[tuple]:
    tr = run.traffic
    return [tuple(w) for w in tr["weights"]
            for _ in range(tr["seeds_per_weighting"])]


def build_env(run, lanes, batch_cfg_steps):
    """The program's stacked environment, schedules and QConfig."""
    from repro_torch.core import qlearn
    from repro_torch.soc import stacked, vecenv
    dev = torch.device(run.device)
    envs = [vecenv.VecEnv(inputs.port_soc(l["soc"]), seed=l["profile_seed"],
                          flavor=l["flavor"], device=dev,
                          cycle_time=run.config["cycle_time"])
            for l in lanes]
    env = stacked.StackedVecEnv([e.soc for e in envs], envs=envs)
    q = run.config["agent"]["qconfig"]
    cfg = qlearn.QConfig(**q, decay_steps=torch.tensor(
        [n * run.config["agent"]["decay_iterations"]
         for n in batch_cfg_steps], dtype=torch.int32))
    return env, cfg


def record_launches(run, state):
    """Keep every episode launch's input table and outputs of the current
    unit (references only: the timed path does no extra work)."""
    from repro_torch.kernels.soc_step import ops
    inner = ops.fused_episode

    def recording(*args, **kw):
        out = inner(*args, **kw)
        state.launches.append((args[3], out))
        return out

    run.patch(ops, "fused_episode", recording)


def setup(run) -> State:
    from repro_torch.core.rewards import stack_weights
    tr = run.traffic
    st = State()
    st.lanes = lanes = lane_plan(run)
    st.weights = weight_rows(run)
    port_train = [inputs.port_app(l["train_app"]) for l in lanes]
    port_eval = [inputs.port_app(l["eval_app"]) for l in lanes]
    st.env, st.cfg = build_env(
        run, lanes, [inputs.app_steps(l["train_app"]) for l in lanes])
    st.iters = [st.env.compile(port_train, seed=it)
                for it in range(tr["iterations"])]
    st.eval = st.env.compile(port_eval, seed=tr["eval_app"]["tile_seed"])
    st.n_steps = [s.n_steps for s in st.iters] + [st.eval.n_steps]
    st.wb = stack_weights(st.weights, device=st.env.device)
    st.k, st.b = len(lanes), len(st.weights)
    st.launches = []
    record_launches(run, st)
    n_train = sum(inputs.app_steps(l["train_app"]) for l in lanes)
    n_eval = sum(inputs.app_steps(l["eval_app"]) for l in lanes)
    st.work = tr["iterations"] * st.b * (n_train + n_eval) + n_eval
    shapes = ([launch_shape(lanes, "train_app", st.b)] * tr["iterations"]
              + [launch_shape(lanes, "eval_app", st.b)] * tr["iterations"]
              + [launch_shape(lanes, "eval_app", 1)])
    run.facts["k1"] = {"bytes_per_unit": sum(roofline.episode_bytes(s)
                                             for s in shapes),
                       "launches_per_unit": len(shapes)}
    if run.warm:                         # warm-up job, outside the window
        unit(run, st, -1)
        run.sync()
    return st


def unit(run, st: State, j: int) -> int:
    st.last, st.launches = None, []      # one job's outputs held at a time
    keys = inputs.unit_keys(run.seed, 0, j + 1, (st.k, st.b))
    qs, hist = st.env.train_batched(st.iters, st.cfg, st.wb, keys,
                                    eval_stacked=st.eval)
    st.last = (j + 1, qs, hist, st.launches)
    return st.work


def finish_window(run, st: State):
    """The rate, then the sampled rows of the last job moved to the host
    and the program's state dropped."""
    run.facts["end_to_end"] = {"train_inv_per_s":
                               run.facts["work"] / run.window_s}
    u, qs, hist, launches = st.last
    rng = np.random.default_rng([run.seed & 0xFFFFFFFF, run.seed >> 32, u])
    per_lane = min(run.traffic["sample_agents_per_lane"], st.b)
    rows = [(k, int(b)) for k in range(st.k)
            for b in sorted(rng.choice(st.b, per_lane, replace=False))]
    st.rows, st.unit_index = rows, u
    idx = torch.tensor([k * st.b + b for k, b in rows])
    lanes_idx = torch.arange(st.k)
    host = lambda t, i: t.index_select(0, i.to(t.device)).cpu()
    st.prog = {
        "base": tuple(host(y, lanes_idx) for y in launches[0][1][-1]),
        "launches": [(host(q_in, idx), host(out[0], idx),
                      tuple(host(y, idx) for y in out[-1]))
                     for q_in, out in launches[1:]],
        "final": rq.QState(*(host(v.reshape(st.k * st.b, *v.shape[2:]),
                                  idx) for v in qs)),
        "hist": tuple(host(h.reshape(st.k * st.b, -1), idx) for h in hist),
    }
    del st.env, st.iters, st.eval, st.launches, st.last
    if run.device == "cuda":
        torch.cuda.empty_cache()


def check(run, st: State) -> list:
    """Follow every sampled agent of the last job through its launches;
    returns ``[(name, value, limit), ...]``."""
    t = rc.Tally(NAMES)
    ref_plan(run, st.lanes)
    count_steps(st, t)
    keys = inputs.unit_keys(run.seed, 0, st.unit_index, (st.k, st.b))
    follow_training(run, st.lanes, st.rows, st.prog, keys, st.weights,
                    run.traffic["iterations"], t)
    run.facts["worst"] = t.worst
    return [(n, t.v[n], LIMITS[n]) for n in NAMES]


def count_steps(st: State, t: rc.Tally):
    """The program's compiled schedules hold the reference's valid steps
    on every lane (the work the rate counts)."""
    ref = [[l["train"][it].n_steps for l in st.lanes]
           for it in range(len(st.n_steps) - 1)]
    ref.append([l["eval"].n_steps for l in st.lanes])
    t.count("step_ints", torch.tensor(st.n_steps), torch.tensor(ref),
            "n_steps")


def follow_training(run, lanes, rows, prog, keys, weights, iters, t):
    """Recompute every launch of one ``train_batched`` call for the
    sampled ``rows`` ((lane, agent) pairs) and tally the gaps in ``t``.
    ``prog`` holds the program's launches for those rows (training and
    evaluation alternating, after a baseline launch), its returned agents
    (``final``) and its histories."""
    nc = int(CoherenceMode.NON_COH_DMA)
    jobs, slots = [], []
    # the baseline: each lane's fixed NON_COH episode, default keys
    for k, lane in enumerate(lanes):
        sched = lane["eval"].schedule
        jobs.append(rc.Job(lane["params"], sched,
                           ep.fixed_policy_spec(lane["params"], sched, nc),
                           rq.QConfig(), rr.PAPER_DEFAULT_WEIGHTS,
                           rq.prng.PRNGKey(k)))
        slots.append(("base", k, None))
    follow = []
    for r, (k, b) in enumerate(rows):
        lane = lanes[k]
        cfg = rq.QConfig(**qconfig(run, lane["train"][0].n_steps))
        w = rr.RewardWeights(*weights[b])
        q = rq.init_qstate_batch(rq.QConfig(), 1)
        best = torch.full((1,), -float("inf"))
        for it, (k_tr, k_ev) in enumerate(rc.keys_chain(keys[k, b], iters)):
            q_in, q_out, ys = prog["launches"][2 * it]
            t.gap("agent_floats", q_in[r], q.qtable[0])
            sched = lane["train"][it].schedule
            jobs.append(rc.Job(lane["params"], sched,
                               ep.learned_policy_spec(q, sched), cfg, w,
                               k_tr))
            slots.append(("train", r, it))
            n = sched.acc_id.shape[0]
            ys = tuple(y[r, :n] for y in ys)
            inc = torch.ones((1, n), dtype=torch.int32)
            q = rq.replay_visits(q, q_out[r][None], ys[1][None], ys[2][None],
                                 inc)
            q, best = rq.reward_watchdog(cfg, q, (ys[5].sum() / n)[None],
                                         best)
            q_ev = rq.freeze(q)
            t.gap("agent_floats", prog["launches"][2 * it + 1][0][r],
                  q_ev.qtable[0])
            esched = lane["eval"].schedule
            jobs.append(rc.Job(lane["params"], esched,
                               ep.learned_policy_spec(q_ev, esched), cfg, w,
                               k_ev))
            slots.append(("eval", r, it))
        follow.append(q)
    outs = rc.run_batch(jobs, run.device)
    base_phase = {}
    for (kind, a, it), job, (q_ref, ys_ref) in zip(slots, jobs, outs):
        n = job.sched.acc_id.shape[0]
        if kind == "base":
            prog_ys = tuple(y[a, :n] for y in prog["base"])
            base_phase[a] = _phases(lanes[a], job.sched, ys_ref, run)
        else:
            _, q_out, ys = prog["launches"][2 * it + (kind == "eval")]
            prog_ys = tuple(y[a, :n] for y in ys)
            t.gap("agent_floats", q_out[a], q_ref)
        for i in (0, 1, 2):
            t.count("step_ints", prog_ys[i], ys_ref[i], ref_step.YCOLS[i])
        for i in (3, 4, 5):
            t.gap("step_floats", prog_ys[i], ys_ref[i], ref_step.YCOLS[i])
        if kind == "eval":
            k = rows[a][0]
            nt, nm = ep.normalized_metrics(
                _phases(lanes[k], job.sched, ys_ref, run), base_phase[k],
                torch.ones(lanes[k]["eval"].n_phases))
            t.gap("history", prog["hist"][0][a, it], nt[0], "time")
            t.gap("history", prog["hist"][1][a, it], nm[0], "off-chip")
    final = prog["final"]
    for r, q in enumerate(follow):
        t.gap("agent_floats", final.qtable[r], q.qtable[0])
        t.count("agent_ints", final.visits[r], q.visits[0])
        t.count("agent_ints", final.step[r], q.step[0])
        t.count("agent_ints", final.frozen[r], q.frozen[0])


def _phases(lane, sched, ys, run) -> ep.EpisodeResult:
    """One episode's per-phase (time, off-chip) from its trace."""
    c = lane["eval"]
    seg = ep.phase_segments(sched, c.n_phases, c.n_threads)
    pt, po = ep.phase_metrics(ys[3][None], ys[4][None], seg,
                              n_phases=c.n_phases, n_threads=c.n_threads,
                              cycle_time=run.config["cycle_time"])
    return ep.EpisodeResult(pt, po, *([None] * 5))
