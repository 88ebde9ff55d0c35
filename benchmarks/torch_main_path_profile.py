"""Where the port's main path spends its time on the card.

    PYTHONPATH=src python -m benchmarks.torch_main_path_profile \
        [--path fig6|fig9|fig10|fig11|fig13|qwen3|rwkv6|granite|\
                recurrentgemma]

Runs one of the full-width paths ``chip_smoke.py`` drives (default the
Fig. 6 slice; ``fig9`` is ``benchmarks/torch_fig9_socs.py``'s port run,
``fig10`` ``benchmarks/torch_fig10_faults.py``'s, ``fig11``
``benchmarks/torch_fig11_serving.py``'s, ``fig13``
``benchmarks/torch_fig13_generalize.py``'s, ``qwen3`` Qwen3-8B serving,
``rwkv6`` rwkv6-3b serving, ``granite`` granite-moe-3b-a800m serving and
``recurrentgemma`` recurrentgemma-9b serving through ``repro_torch.launch.serve`` at ``chip_smoke.py``'s shape, with
the weights made once) once to warm up,
then (1) times its wall and its host-side pieces one by one with the
device synchronized around each (for the two serving paths: ``serve``'s
own phase times), and (2) runs it again under ``torch.profiler``
and prints the device's busy share of the wall time and the device time
by kernel name (device events only).  Needs a CUDA card; prints the card's name and power
limit beside every number.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core import orchestrator as orch
from repro_torch.core import policies as pol
from repro_torch.core import qlearn, rewards
from repro_torch.core.modes import CoherenceMode
from repro_torch.kernels.soc_step import ops as soc_ops
from repro_torch.soc import apps, vecenv as vec
from repro_torch.soc.config import SOC_MOTIV_PAR

WEIGHTS = [
    (0.675, 0.075, 0.25), (0.125, 0.125, 0.75), (1.0, 0.0, 0.0),
    (0.0, 0.0, 1.0), (0.05, 0.05, 0.90), (0.33, 0.33, 0.34),
    (0.5, 0.25, 0.25), (0.25, 0.5, 0.25), (0.8, 0.1, 0.1),
    (0.1, 0.8, 0.1), (0.45, 0.1, 0.45), (0.6, 0.0, 0.4),
    (0.9, 0.05, 0.05), (0.2, 0.2, 0.6), (0.4, 0.4, 0.2),
]


def main_path(env):
    res = orch.train_cohmeleon_batched(
        SOC_MOTIV_PAR, iterations=10, seed=11, weights=WEIGHTS, n_seeds=8,
        n_phases=6, env=env)
    test_app = apps.make_application(SOC_MOTIV_PAR, seed=900, n_phases=6)
    res.evaluate(test_app, seed=5)
    suite = ([pol.FixedHomogeneous(m) for m in CoherenceMode]
             + [pol.RandomPolicy(), pol.ManualPolicy(), res.qpolicy(0)])
    orch.compare_policies(env, test_app, suite, seed=5)
    torch.cuda.synchronize()


def timed(fn, reps=3):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out)) * 1e3


def fig6_pieces(env, dev):
    soc = SOC_MOTIV_PAR
    app = apps.make_application(soc, seed=11, n_phases=6)
    compiled = vec.compile_app(app, soc, seed=11)
    sched = compiled.schedule.to(dev)
    b = len(WEIGHTS) * 8
    cfg = qlearn.QConfig(decay_steps=compiled.n_steps * 10)
    keys = prng.PRNGKey(np.arange(b), device=dev)
    wb = rewards.stack_weights(WEIGHTS * 8, device=dev)
    spec = vec.learned_policy_spec(qlearn.init_qstate_batch(cfg, b, dev),
                                   sched)
    xs, inc = vec.episode_inputs(env.params, sched, spec, cfg, keys)
    extrema0 = rewards.init_reward_state(soc.n_accs, (b,), dev).extrema
    kernel = lambda: soc_ops.fused_episode(
        env.params.static, spec.learned.expand(b), wb, spec.qstate.qtable,
        extrema0, xs, ddr_attribution=env.ddr_attribution)
    qtable, ys = kernel()
    segments = vec.phase_segments(sched, compiled.n_phases,
                                  compiled.n_threads)
    return {
        "make_application + compile_app (1 iteration)": lambda:
            vec.compile_app(apps.make_application(soc, seed=11, n_phases=6),
                            soc, seed=11),
        "manual policy mode table (540-step loop)": lambda:
            vec.manual_policy_spec(env.params, sched),
        "episode inputs (noise, decay, pregather)": lambda:
            vec.episode_inputs(env.params, sched, spec, cfg, keys),
        "one training episode, B=120 (inputs + kernel + metric tail)":
            lambda: env._run(compiled, sched, spec, cfg, wb, keys),
        "K1 alone, B=120": kernel,
        "phase sum index (phase_segments, before each launch)": lambda:
            vec.phase_segments(sched, compiled.n_phases, compiled.n_threads),
        "metric tail, B=120 (visits replay + phase sums)": lambda:
            vec.episode_tail(spec.qstate, qtable, ys, inc, vec.phase_metrics(
                ys[3], ys[4], segments, n_phases=compiled.n_phases,
                n_threads=compiled.n_threads, cycle_time=env.cycle_time)),
        "visits replay alone, B=120": lambda:
            qlearn.replay_visits(spec.qstate, qtable, ys[1], ys[2], inc),
    }


def fig9_pieces(dev):
    from benchmarks.torch_fig9_socs import SOC_FLAVORS
    from repro_torch.soc.config import SOCS
    from repro_torch.soc.stacked import StackedVecEnv
    envs = [vec.VecEnv(SOCS[n], seed=1, flavor=f, device=dev)
            for n, f in SOC_FLAVORS]
    env = StackedVecEnv([e.soc for e in envs], envs=envs)
    st = env.compile([apps.make_application(e.soc, seed=50, n_phases=8)
                      for e in envs], seed=4)
    return {
        "profile_fixed_heterogeneous, 8 lanes (222 one-step launches)":
            lambda: [orch.profile_fixed_heterogeneous(e) for e in envs],
        "manual policy mode tables, 8 lanes (lower)": lambda:
            env.lower(st, [pol.ManualPolicy()]),
        "compile 8 training apps (1 iteration)": lambda:
            env.compile([apps.make_application(e.soc, seed=0, n_phases=8)
                         for e in envs], seed=0),
    }


def fig11_pieces(dev):
    from benchmarks.torch_fig11_serving import _traffic
    from repro_torch.soc import traffic
    from repro_torch.soc.config import SOCS
    soc = SOCS["SoC1"]
    env = vec.VecEnv(soc, seed=1, device=dev)
    app = vec.compile_app(apps.make_application(soc, seed=50, n_phases=8),
                          soc, seed=4)
    sched = env._sched(app)
    specs = vec.stack_specs([vec.fixed_policy_spec(env.params, sched, m)
                             for m in (0, 3, 1, 2)])
    tspec = _traffic(traffic, 2.94e-6, 1.9e7, 6e5, device=dev)
    serve_env = vec.ServeEnv(env, queue_cap=8, n_requests=1024)
    return {
        "sample_arrivals (1,024 requests)": lambda:
            traffic.sample_arrivals(tspec, 1024, sched.acc_id.shape[0]),
        "one serving call, B=4 x 1,024 requests (inputs + kernel + "
        "results)": lambda: serve_env.serve_specs(app, specs, tspec),
        "manual policy mode table (eval app)": lambda:
            vec.manual_policy_spec(env.params, sched),
    }


def fig10_pieces(dev):
    from benchmarks.torch_fig10_faults import ITERS, N_PHASES
    from repro_torch.soc import faults
    from repro_torch.soc.config import SOCS
    soc = SOCS["SoC1"]
    env = vec.VecEnv(soc, seed=1, device=dev)
    train = [vec.compile_app(apps.make_application(soc, seed=0,
                                                   n_phases=N_PHASES),
                             soc, seed=it) for it in range(ITERS)]
    app = vec.compile_app(apps.make_application(soc, seed=50,
                                                n_phases=N_PHASES),
                          soc, seed=4)
    sched = env._sched(app)
    fs = faults.storm(app.n_steps, 1.0, prng.PRNGKey(42))
    cfg = qlearn.QConfig(decay_steps=train[0].n_steps * ITERS,
                         collapse_frac=0.25)
    wb = rewards.stack_weights([rewards.PAPER_DEFAULT_WEIGHTS])
    keys = prng.PRNGKey(np.arange(1))
    spec = vec.learned_policy_spec(qlearn.init_qstate(device=dev), sched)
    specs = vec.stack_specs(
        [vec.fixed_policy_spec(env.params, sched, m) for m in range(4)]
        + [vec.manual_policy_spec(env.params, sched), spec])
    return {
        "training under the severe storm (10 iterations, 21 K1f "
        "launches)": lambda: env.train_batched(train, cfg, wb, keys,
                                               eval_app=app, faults=fs),
        "six-policy evaluation under the severe storm (one K1f launch)":
            lambda: env.episodes(app, specs, cfg, faults=fs),
        "fault rows of the eval app (sample_fault_arrays)": lambda:
            faults.sample_fault_arrays(fs, sched.acc_id),
        "faulted episode inputs, B=1 (noise, decay, pregather, rows)":
            lambda: vec.episode_inputs(env.params, sched, spec, cfg,
                                       keys.to(dev), faults=fs),
        "manual policy mode table (eval app)": lambda:
            vec.manual_policy_spec(env.params, sched),
    }


def fig13_pieces(dev):
    from benchmarks import torch_fig13_generalize as f13
    from repro_torch.soc import dse, nn as socnn
    s = dse.sample_socs(0, 1)[0]
    env = vec.VecEnv(s.config, seed=0, device=dev)
    app = f13._compile(vec, apps.make_application, s.config, s.seed,
                       f13.N_PHASES)
    sched = env._sched(app)
    cfg = qlearn.QConfig(decay_steps=app.n_steps * f13.ITERS)
    keys = prng.PRNGKey(np.arange(f13.BATCH), device=dev)
    spec = vec.expand_spec(vec.mlp_policy_spec(
        socnn.init_mlp_qstate(prng.PRNGKey(1, device=dev)), sched),
        f13.BATCH)
    table = vec.learned_policy_spec(qlearn.init_qstate(device=dev), sched)
    return {
        f"portfolio training episode, B={f13.BATCH} ({app.n_steps} steps, "
        "one K1m launch)": lambda: env._run(
            app, sched, spec, cfg, rewards.PAPER_DEFAULT_WEIGHTS, keys),
        "MLP episode inputs (noise, merged decay, pregather)": lambda:
            vec.episode_inputs(env.params, sched, spec, cfg, keys),
        "shared-table episode, B=1 (one K1 launch)": lambda:
            env.episode(app, policy="q", qstate=table.qstate, cfg=cfg,
                        key=keys[0]),
        "compile one 3-phase application (host)": lambda: f13._compile(
            vec, apps.make_application, s.config, s.seed, f13.N_PHASES),
    }


LM_ARCHS = {"qwen3": "qwen3-8b", "rwkv6": "rwkv6-3b",
            "granite": "granite-moe-3b-a800m",
            "recurrentgemma": "recurrentgemma-9b"}


def lm_path(dev, arch):
    """(run, phases): one serve of ``arch`` over 4 x 2,048 prompt tokens
    and 32 generated, weights made once, and the last run's phase
    times."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    cfg = get_arch(arch)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    phases = {}

    def run():
        out = serve(cfg, 4, 2048, 32, device=dev, params=params)
        phases.update({"bf16 weight copy (compute_copy)": out["cast_s"],
                       "prefill B=4 S=2048": out["prefill_s"],
                       "decode, 32 steps": out["decode_s"]})
    return run, phases


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="fig6",
                    choices=("fig6", "fig9", "fig10", "fig11", "fig13",
                             *LM_ARCHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    dev = torch.device("cuda")
    if args.path == "fig6":
        env = vec.VecEnv(SOC_MOTIV_PAR, device=dev)
        run = lambda: main_path(env)
        pieces = fig6_pieces(env, dev)
    elif args.path == "fig9":
        from benchmarks.torch_fig9_socs import run_port
        run = lambda: run_port(dev)
        pieces = fig9_pieces(dev)
    elif args.path == "fig10":
        from benchmarks.torch_fig10_faults import run_port
        run = lambda: run_port(dev)
        pieces = fig10_pieces(dev)
    elif args.path == "fig13":
        from benchmarks.torch_fig13_generalize import run_port
        run = lambda: run_port(dev)
        pieces = fig13_pieces(dev)
    elif args.path in LM_ARCHS:
        run, phases = lm_path(dev, LM_ARCHS[args.path])
        pieces = {}
    else:
        from benchmarks.torch_fig11_serving import run_port
        run = lambda: run_port(dev)
        pieces = fig11_pieces(dev)
    run()                                            # warm-up + build
    wall = timed(run, reps=3)
    print(f"card: {card}")
    print(f"{args.path} path: {wall:.1f} ms wall (median of 3)")
    for name, fn in pieces.items():
        print(f"{name}: {timed(fn):.2f} ms on {card}")
    if args.path in LM_ARCHS:
        for name, secs in phases.items():
            print(f"{name}: {secs * 1e3:.2f} ms (last timed run) on {card}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, sets): an operator's own
    # row repeats the device time of the kernels it launched
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us:
            rows.append((dev_us, evt.key, evt.count))
    busy = sum(r[0] for r in rows) / 1e3
    print(f"traced {args.path} path: {traced:.1f} ms wall, device busy "
          f"{busy:.1f} ms ({100 * busy / traced:.1f}%), idle "
          f"{100 * (1 - busy / traced):.1f}% on {card}")
    for dev_us, key, count in sorted(rows, reverse=True)[:16]:
        print(f"  device {dev_us / 1e3:9.2f} ms  x{count:<6d} {key[:70]}")


if __name__ == "__main__":
    main()
