"""Fig. 11 (always-on serving) through the PyTorch/CUDA port, beside the
JAX reference.

    PYTHONPATH=src python -m benchmarks.torch_fig11_serving \
        [--fidelity] [--device cuda|cpu] [--out port.json] \
        [--compare port.json] [--reference] [--no-fma]

The port's run mirrors ``benchmarks/fig11_serving.py``'s ``_run`` at full
width: SoC1, one agent trained for 10 iterations of an 8-phase app (one
kernel launch per training and per evaluation episode), capacity
calibrated by two NON_COH probes, then four policies (fixed NON_COH, fixed
FULLY_COH, manual, the frozen agent) serving 1,024 requests of a
two-tenant bursty stream at 0.2x to 2x capacity, one serve-kernel launch
per load; and the ``traffic=None`` identity (serving without traffic is
the episode, bitwise).  It prints the capacity calibration and per load
and policy the served/shed counts, p50/p99 latency and the degraded
fraction, with launches and wall times, and writes them to ``--out``.
``--compare`` loads such a JSON instead of running the port;
``--reference`` runs the reference's ``fig11_serving._run`` on the CPU
(which writes no report) and prints the differences; ``--no-fma``
compiles it for an ISA without fused multiply-add (ROADMAP C1).  The
reference's jit-cache check (``_retrace``) has no counterpart here: the
port compiles nothing per call.  The port side imports no JAX.

After the figure, timed apart from it, the DES cross-check
(:func:`des_crosscheck`, the reference's ``_des_crosscheck``): the
batched serving path against the event-driven simulator's serving
mirror (``SoCSimulator.serve``) on the same arrival tables, SoC1 with
``queue_cap`` 4 and 512 requests a stream at a 1x rate calibrated from a
NON_COH probe, fixed families only; ``--fidelity`` runs loads 0.5, 1 and
1.5 x the four modes (6,144 requests), else 1x NON_COH.  Admission
decisions must be equal and latencies within ``1e-3 * latency + 8
ulp(float32 t_end)``.  With ``--reference`` the reference's cross-check
runs too.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from benchmarks.torch_no_fma import use_reference_without_fma

SOC_NAME = "SoC1"
LOADS = [0.2, 0.5, 1.0, 1.5, 2.0]
QUEUE_CAP = 8
N_REQUESTS, ITERS, N_PHASES = 1024, 10, 8
POLICIES = ["fixed_non_coh", "fixed_fully_coh", "manual", "cohmeleon"]
_MAX_RETRIES = 3
METRICS = ("served", "shed_frac", "p50_latency", "p99_latency",
           "degraded_frac", "mean_retries", "mean_exec",
           "throughput_per_mcycle")


def _traffic(mod, rate: float, deadline: float, backoff: float,
             seed: int = 3, device=None):
    """The figure's two-tenant bursty spec at offered ``rate``."""
    return mod.bursty(rate, burst_rate=4.0, p_burst=0.05, p_calm=0.25,
                      mix=(0.7, 0.3), deadline=(deadline, 0.0),
                      priority=(1.0, 0.25), backoff=backoff,
                      overload_frac=0.35, prio_reserve=0.25, seed=seed,
                      device=device)


def load_traffic(mult: float, cap: dict, device=None):
    """The figure's traffic at ``mult`` x the capacity that :func:`run_port`
    calibrated (its ``_capacity``): the deadline a full queue's service,
    the backoff a quarter of one."""
    from repro_torch.soc import traffic
    svc = cap["effective_service_cycles"]
    return _traffic(traffic, mult * cap["capacity_per_mcycle"] * 1e-6,
                    QUEUE_CAP * svc, 0.25 * svc, device=device)


def mlp_serving_policies(env, eval_app, n_requests: int = N_REQUESTS,
                         iters: int = ITERS, n_phases: int = N_PHASES):
    """The MLP serving path's four policies on ``env``'s SoC: a Q-table
    trained as the figure trains it (K1) and a (14, 16, 16, 4) sense
    network (Fig. 13's MLPConfig) trained through K1m for as many
    iterations, stacked as the learning network, its frozen copy, the
    Q-table and fixed NON_COH (the last two with placeholder networks).
    Returns ``(net, specs, cfg)``: the trained network, the stacked specs
    on ``eval_app``'s schedule and the serving QConfig (its decay runs
    ``2 * n_requests`` past the network's training steps)."""
    from repro_torch import random as prng
    from repro_torch.core import qlearn, rewards
    from repro_torch.soc import apps, nn as socnn, vecenv

    dev = env.device
    train_app = apps.make_application(env.soc, seed=0, n_phases=n_phases)
    t_apps = [vecenv.compile_app(train_app, env.soc, seed=it)
              for it in range(iters)]
    cfg_t = qlearn.QConfig(decay_steps=t_apps[0].n_steps * iters,
                           collapse_frac=0.25)
    qs_t, _ = env.train_batched(
        t_apps, cfg_t, rewards.stack_weights([rewards.PAPER_DEFAULT_WEIGHTS]),
        prng.PRNGKey(np.arange(1)), eval_app=eval_app)
    net = socnn.init_mlp_qstate(prng.PRNGKey(11, device=dev))
    for it, ta in enumerate(t_apps):
        (_, net), _ = env.episode_spec(
            ta, vecenv.mlp_policy_spec(net, env._sched(ta)), cfg=cfg_t,
            key=prng.PRNGKey(100 + it, device=dev))
    sched = env._sched(eval_app)
    specs = vecenv.stack_specs([
        vecenv.mlp_policy_spec(net, sched),
        vecenv.mlp_policy_spec(socnn.freeze(net), sched),
        vecenv.attach_placeholder_mlp(vecenv.learned_policy_spec(qs_t,
                                                                 sched)),
        vecenv.attach_placeholder_mlp(vecenv.fixed_policy_spec(
            env.params, sched, 0))])
    cfg = qlearn.QConfig(decay_steps=int(net.step[0]) + 2 * n_requests)
    return net, specs, cfg


def policy_metrics(res, i, t_span, queue_cap, backoff) -> dict:
    """Row ``i`` of a serve_specs batch (numpy leaves), as the reference
    computes it: throughput counts requests finishing inside the arrival
    window."""
    ex = res["executed"][i]
    lat = res["latency"][i][ex]
    exec_t = res["exec_time"][i][ex]
    t_end = float(res["t_arr"][i][-1])
    completed = int((ex & (res["finish"][i] <= t_end)).sum())
    n = ex.shape[0]
    served = int(ex.sum())
    bound = (backoff * (2.0 ** _MAX_RETRIES - 1.0)
             + (queue_cap + 1) * float(exec_t.max()) if served else 0.0)
    p50, p99 = (map(float, np.percentile(lat, [50, 99]))
                if served else (0.0, 0.0))
    return {
        "offered": n, "served": served,
        "shed_frac": float(1.0 - served / n),
        "throughput_per_mcycle": float(completed / t_span * 1e6),
        "p50_latency": p50, "p99_latency": p99,
        "p99_bound": float(bound),
        "p99_bounded": bool(p99 <= bound) if served else True,
        "degraded_frac": float(res["degraded"][i][ex].mean())
        if served else 0.0,
        "mean_retries": float(res["retries"][i][ex].mean())
        if served else 0.0,
        "mean_exec": float(exec_t.mean()) if served else 0.0,
    }


def _np(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in res._fields}


def run_port(device=None, n_requests: int = N_REQUESTS,
             iters: int = ITERS, n_phases: int = N_PHASES) -> dict:
    from repro_torch import random as prng, resolve_device
    from repro_torch.core import qlearn
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.core.rewards import PAPER_DEFAULT_WEIGHTS, stack_weights
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc import traffic, vecenv
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOCS

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    soc_ops.reset_launches()
    t0 = time.perf_counter()
    soc = SOCS[SOC_NAME]
    env = vecenv.VecEnv(soc, seed=1, flavor="mixed", device=dev)
    train_app = make_application(soc, seed=0, n_phases=n_phases)
    train_apps = [vecenv.compile_app(train_app, soc, seed=it)
                  for it in range(iters)]
    eval_app = vecenv.compile_app(
        make_application(soc, seed=50, n_phases=n_phases), soc, seed=4)
    cfg = qlearn.QConfig(decay_steps=train_apps[0].n_steps * iters,
                         collapse_frac=0.25)
    qs, _ = env.train_batched(train_apps, cfg,
                              stack_weights([PAPER_DEFAULT_WEIGHTS]),
                              prng.PRNGKey(np.arange(1)),
                              eval_app=eval_app)
    agent = qlearn.freeze(qs)
    sync()
    t_train = time.perf_counter()
    launches_train = soc_ops.launches

    serve_env = vecenv.ServeEnv(env, queue_cap=QUEUE_CAP,
                                n_requests=n_requests)
    sched = env._sched(eval_app)
    fixed = lambda m: vecenv.fixed_policy_spec(env.params, sched, int(m))
    probe = fixed(CoherenceMode.NON_COH_DMA)
    _, _, pres = serve_env.serve(eval_app, probe,
                                 traffic.poisson(1e-9, seed=3), cfg=cfg,
                                 key=prng.PRNGKey(7))
    ex = pres.executed.cpu().numpy()
    mean_exec = float(pres.exec_time.cpu().numpy()[ex].mean())
    _, _, hres = serve_env.serve(
        eval_app, probe,
        traffic.poisson(10.0 * soc.n_accs / mean_exec, seed=3), cfg=cfg,
        key=prng.PRNGKey(7))
    t_h = hres.t_arr.cpu().numpy()
    t0_h, t1_h = float(t_h[0]), float(t_h[-1])
    done = (hres.executed.cpu().numpy()
            & (hres.finish.cpu().numpy() <= t1_h))
    cap_rate = float(done.sum()) / (t1_h - t0_h)
    svc = soc.n_accs / cap_rate
    deadline = QUEUE_CAP * svc
    backoff = 0.25 * svc

    specs = vecenv.stack_specs([
        fixed(CoherenceMode.NON_COH_DMA), fixed(CoherenceMode.FULLY_COH),
        vecenv.manual_policy_spec(env.params, sched),
        vecenv.learned_policy_spec(agent, sched)])
    results: dict = {}
    sync()
    t_sweep = time.perf_counter()
    for mult in LOADS:
        tspec = _traffic(traffic, mult * cap_rate, deadline, backoff)
        _, _, res = serve_env.serve_specs(eval_app, specs, tspec, cfg=cfg)
        r = _np(res)
        t_span = float(r["t_arr"][0, -1] - r["t_arr"][0, 0])
        results[f"{mult:g}x"] = {
            "load_mult": mult,
            "offered_rate_per_mcycle": float(mult * cap_rate * 1e6),
            **{name: policy_metrics(r, i, t_span, QUEUE_CAP, backoff)
               for i, name in enumerate(POLICIES)},
        }
    sync()
    t_end = time.perf_counter()
    results["_capacity"] = {
        "mean_exec_cycles": mean_exec, "effective_service_cycles": svc,
        "capacity_per_mcycle": float(cap_rate * 1e6),
        "deadline_cycles": deadline, "queue_cap": QUEUE_CAP,
        "n_requests": n_requests,
    }

    key = prng.PRNGKey(5)
    spec_q = vecenv.learned_policy_spec(agent, sched)
    qs_a, res_a = serve_env.serve(eval_app, spec_q, None, cfg=cfg, key=key)
    qs_b, res_b = env.episode_spec(eval_app, spec_q, cfg=cfg, key=key)
    fields = [f"qstate.{f}" for f in qs_a._fields] + [
        f"result.{f}" for f in res_a._fields]
    differ = [f for f, a, b in zip(fields, (*qs_a, *res_a), (*qs_b, *res_b))
              if not torch.equal(a, b)]
    results["_identity"] = {"traffic_none_bitwise": not differ,
                            "differing": differ}
    results["_engine"] = {
        "path": "repro_torch",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "episode_launches": soc_ops.launches,
        "episode_launches_train": launches_train,
        "serve_launches": soc_ops.serve_launches,
        "expected_episode_launches": 2 * iters + 1 + 2,
        "expected_serve_launches": 2 + len(LOADS),
        "wall_s": t_end - t0, "train_s": t_train - t0,
        "calibrate_s": t_sweep - t_train, "sweep_s": t_end - t_sweep,
    }
    return results


def des_crosscheck(device=None, fidelity: bool = False,
                   n: int = 512) -> dict:
    """The batched serving path against the event-driven serving mirror
    on single-tenant Poisson streams; both consume the same presampled
    arrival table, so admission must match exactly and latencies to the
    float32 clock's tolerance.  Fixed families only: their choice is
    context-free, so a disagreement is a serving-model divergence.
    Returns the verdict with the launches and walls of each side."""
    from repro_torch import resolve_device
    from repro_torch.core import qlearn
    from repro_torch.core.modes import CoherenceMode
    from repro_torch.core.policies import FixedHomogeneous
    from repro_torch.kernels.soc_step import ops as soc_ops
    from repro_torch.soc import traffic, vecenv
    from repro_torch.soc.apps import make_application
    from repro_torch.soc.config import SOCS
    from repro_torch.soc.des import SoCSimulator

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    soc_ops.reset_launches()
    t0 = time.perf_counter()
    soc = SOCS[SOC_NAME]
    sim = SoCSimulator(soc, seed=1, flavor="mixed", device=dev)
    env = vecenv.VecEnv.from_simulator(sim)
    eval_app = vecenv.compile_app(
        make_application(soc, seed=50, n_phases=4), soc, seed=4)
    queue_cap = 4
    serve_env = vecenv.ServeEnv(env, queue_cap=queue_cap, n_requests=n)
    cfg = qlearn.QConfig()

    # a 1x rate from a near-idle probe, so the streams fill queues
    probe = env.lower(eval_app, "fixed",
                      fixed_modes=CoherenceMode.NON_COH_DMA)
    _, _, pres = serve_env.serve(eval_app, probe,
                                 traffic.poisson(1e-9, seed=3), cfg=cfg)
    ex = pres.executed.cpu().numpy()
    mean_exec = float(pres.exec_time.cpu().numpy()[ex].mean())
    rate_1x = soc.n_accs / mean_exec

    mults = [0.5, 1.0, 1.5] if fidelity else [1.0]
    modes = (list(CoherenceMode) if fidelity
             else [CoherenceMode.NON_COH_DMA])
    n_rows = eval_app.schedule.acc_id.shape[0]
    max_rel, mismatches, checked = 0.0, 0, 0
    t_vec = t_des = 0.0
    des_requests = 0
    for mult in mults:
        tp = traffic.poisson(
            mult * rate_1x, deadline=3.0 * queue_cap * mean_exec,
            backoff=0.5 * mean_exec, seed=11)
        arr = traffic.sample_arrivals(tp, n, n_rows)
        for mode in modes:
            t1 = time.perf_counter()
            spec = env.lower(eval_app, "fixed", fixed_modes=mode)
            _, _, res = serve_env.serve(eval_app, spec, tp, cfg=cfg)
            v_ex = res.executed.cpu().numpy()
            v_lat_all = res.latency.cpu().numpy()
            t_end = float(res.t_arr.cpu().numpy()[-1])
            t2 = time.perf_counter()
            des = sim.serve(eval_app.schedule, FixedHomogeneous(mode),
                            arr, queue_cap=queue_cap,
                            backoff=float(tp.backoff))
            sync()
            t3 = time.perf_counter()
            t_vec += t2 - t1
            t_des += t3 - t2
            des_requests += n
            d_ex = np.array([r["executed"] for r in des])
            mismatches += int((v_ex != d_ex).sum())
            both = v_ex & d_ex
            v_lat = v_lat_all[both]
            d_lat = np.array([r["latency"] for r in des])[both]
            # the batched clock is float32 and the simulator's float64: a
            # latency is a difference of two stamps of the clock's size,
            # so the bound owes float32 ULPs at the stream's end
            ulp = float(np.spacing(np.float32(t_end)))
            err = np.abs(v_lat - d_lat)
            max_rel = max(max_rel, float(np.max(
                err / (1e-3 * np.maximum(d_lat, 1e-30) + 8.0 * ulp),
                initial=0.0)))
            checked += n
    sync()
    wall = time.perf_counter() - t0
    return {"max_err_vs_tolerance": max_rel,
            "admission_mismatches": mismatches,
            "requests_checked": checked,
            "agree": bool(mismatches == 0 and max_rel <= 1.0),
            "loads": len(mults), "families": len(modes),
            "_engine": {
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "serve_launches": soc_ops.serve_launches,
                "episode_launches": soc_ops.launches,
                "expected_serve_launches": 1 + len(mults) * len(modes),
                "wall_s": wall, "vec_s": t_vec, "des_s": t_des,
                "des_requests": des_requests,
                "des_requests_per_s": des_requests / t_des,
                "des_invocations": sim.invocations}}


def print_crosscheck(tag: str, x: dict) -> None:
    print(f"{tag} DES cross-check: {x['loads']} loads x {x['families']} "
          f"modes, {x['requests_checked']} requests, admission mismatches "
          f"{x['admission_mismatches']}, max error / tolerance "
          f"{x['max_err_vs_tolerance']:.6g}, agree {x['agree']}")
    e = x.get("_engine")
    if e:
        print(f"{tag} DES cross-check engine: {e['device']} wall "
              f"{e['wall_s']:.3f} s (batched {e['vec_s']:.3f}, DES "
              f"{e['des_s']:.3f}: {e['des_requests_per_s']:.1f} requests "
              f"a second); serve launches {e['serve_launches']} (expected "
              f"{e['expected_serve_launches']}), episode launches "
              f"{e['episode_launches']}")


def run_reference() -> dict:
    """The reference's full-width ``_run`` (no report)."""
    from benchmarks.fig11_serving import _run
    return _run(quick=False)


def print_results(tag: str, results: dict) -> None:
    c = results["_capacity"]
    print(f"{tag} capacity: mean_exec={c['mean_exec_cycles']:.6g} "
          f"service={c['effective_service_cycles']:.6g} "
          f"capacity_per_mcycle={c['capacity_per_mcycle']:.6g}")
    for label, row in results.items():
        if label.startswith("_"):
            continue
        for name in POLICIES:
            m = row[name]
            print(f"{tag} {label} {name}: served={m['served']} "
                  f"shed={m['offered'] - m['served']} "
                  f"p50={m['p50_latency']:.6g} p99={m['p99_latency']:.6g} "
                  f"degraded_frac={m['degraded_frac']:.6g}")
    print(f"{tag} traffic=None bitwise: "
          f"{results['_identity']['traffic_none_bitwise']}")


def compare(port: dict, ref: dict) -> float:
    """Print every differing metric; returns the largest relative gap."""
    gap = 0.0
    for k in ("mean_exec_cycles", "effective_service_cycles",
              "capacity_per_mcycle"):
        a, b = port["_capacity"][k], ref["_capacity"][k]
        g = abs(a - b) / max(abs(b), 1e-30)
        gap = max(gap, g)
        print(f"capacity {k}: port {a:.9g} reference {b:.9g} rel {g:.3g}")
    for label, row in ref.items():
        if label.startswith("_"):
            continue
        for name in POLICIES:
            for k in METRICS:
                a, b = port[label][name][k], row[name][k]
                g = abs(a - b) / max(abs(b), 1e-30)
                gap = max(gap, g)
                if g > 0:
                    print(f"differs {label} {name} {k}: port {a:.9g} "
                          f"reference {b:.9g}")
    print(f"largest relative difference: {gap:.6g}")
    return gap


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fidelity", action="store_true",
                    help="cross-check the four fixed modes against the "
                         "event-driven serving mirror at three loads")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out")
    ap.add_argument("--compare")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    if args.compare:
        with open(args.compare) as f:
            port = json.load(f)
    else:
        port = run_port(args.device)
        port["_des_crosscheck"] = des_crosscheck(args.device,
                                                 args.fidelity)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(port, f, indent=1)
    print_results("port", port)
    if "_des_crosscheck" in port:
        print_crosscheck("port", port["_des_crosscheck"])
    e = port["_engine"]
    print(f"port engine: {e['device']} wall {e['wall_s']:.3f} s (train "
          f"{e['train_s']:.3f}, calibrate {e['calibrate_s']:.3f}, sweep "
          f"{e['sweep_s']:.3f}); episode launches {e['episode_launches']} "
          f"(expected {e['expected_episode_launches']}), serve launches "
          f"{e['serve_launches']} (expected "
          f"{e['expected_serve_launches']})")
    if args.reference or args.compare:
        if args.no_fma:
            use_reference_without_fma()
        ref = run_reference()
        print_results("reference", ref)
        compare(port, ref)
        if "_des_crosscheck" in port:
            from benchmarks.fig11_serving import _des_crosscheck
            x = port["_des_crosscheck"]
            print_crosscheck("reference", _des_crosscheck(
                False, x["loads"] > 1))


if __name__ == "__main__":
    main()
