"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``soc_step_episode`` and
``soc_step_serve``, one source) from this checkout and holds each against
its plain PyTorch version at the shapes its paths give it; checks the card
against the CPU plain path on small inputs (batched training, serving,
stacked episodes on 2 lanes); then drives three paths at full width, each
with the launch counts set to 0 just before it and read just after:

  * Fig. 6, the reward sweep on SOC_MOTIV_PAR: 15 weightings x 8 seeds =
    120 agents trained for 10 iterations of a 540-step app, one launch per
    iteration, then frozen evaluation and the 7-policy comparison;
  * Fig. 9, eight Table-4 SoC lanes (``benchmarks/torch_fig9_socs.py``):
    stacked training, profiled heterogeneous baselines, every policy
    family on every lane in one launch;
  * Fig. 11, always-on serving on SoC1 (``benchmarks/
    torch_fig11_serving.py``): training, capacity calibration, four
    policies serving 1,024 requests at five offered loads.

It checks each path's kernel launch counts and finite outputs, prints the
paths' headline numbers and wall times, and times each kernel, its plain
version and its bound.  Exits non-zero, printing no result, without a CUDA
card or outside a checkout of the repository.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it lists
every ported kernel with its numbers.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
TOL = 2e-5                    # rtol = atol of every float comparison

# benchmarks/fig6_reward_dse.py: the 15 weightings of the sweep
WEIGHTS = [
    (0.675, 0.075, 0.25), (0.125, 0.125, 0.75), (1.0, 0.0, 0.0),
    (0.0, 0.0, 1.0), (0.05, 0.05, 0.90), (0.33, 0.33, 0.34),
    (0.5, 0.25, 0.25), (0.25, 0.5, 0.25), (0.8, 0.1, 0.1),
    (0.1, 0.8, 0.1), (0.45, 0.1, 0.45), (0.6, 0.0, 0.4),
    (0.9, 0.05, 0.05), (0.2, 0.2, 0.6), (0.4, 0.4, 0.2),
]
N_SEEDS, ITERS, N_PHASES, SEED = 8, 10, 6, 11
TEST_SEED, TEST_TILE_SEED = 900, 5
SERVE_INT_COLS = ("mode", "state_idx", "action", "executed", "retries",
                  "depth", "degraded")


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(code)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card, by CUDA events."""
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def compare_cols(torch, what, cols, got, want, int_cols):
    """Equal integer columns, floats within TOL; returns the max abs
    error."""
    err = 0.0
    for c, name in enumerate(cols):
        a, r = got[..., c], want[..., c]
        if name in int_cols:
            if not torch.equal(a, r):
                bad = (a != r).nonzero()[0].tolist()
                fail(f"{what}: {name} differs first at {bad}: kernel "
                     f"{a[tuple(bad)].item()} plain {r[tuple(bad)].item()}")
        else:
            if not torch.allclose(a, r, rtol=TOL, atol=TOL):
                fail(f"{what}: {name} max abs err "
                     f"{(a - r).abs().max().item()}")
            err = max(err, (a - r).abs().max().item())
    return err


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np
        from benchmarks import torch_fig9_socs as fig9
        from benchmarks import torch_fig11_serving as fig11
        from repro_torch import random as prng
        from repro_torch.core import orchestrator as orch
        from repro_torch.core import policies as pol
        from repro_torch.core import qlearn, rewards
        from repro_torch.core.modes import CoherenceMode
        from repro_torch.kernels.soc_step import kernel as soc_kernel
        from repro_torch.kernels.soc_step import ops as soc_ops
        from repro_torch.kernels.soc_step import ref as soc_ref
        from repro_torch.soc import apps, traffic, vecenv as vec
        from repro_torch.soc.config import SOC_MOTIV_PAR, SOCS
        from repro_torch.soc.stacked import StackedVecEnv
    except ImportError as e:
        fail(f"the repro_torch package is not in this checkout ({e})")

    dev = torch.device("cuda")
    card = card_line()
    nvcc = subprocess.run([soc_kernel._nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"nvcc {nvcc.strip().splitlines()[-1]}")

    # ---- 1. build (one nvcc for the one source of both kernels) ----------
    t0 = time.perf_counter()
    lib = soc_kernel.build(verbose=True)
    print(f"build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- 2. soc_step_episode vs plain at the Fig. 6 shapes ----------------
    soc = SOC_MOTIV_PAR
    env = vec.VecEnv(soc, device=dev)
    train_app = apps.make_application(soc, seed=SEED, n_phases=N_PHASES)
    compiled = vec.compile_app(train_app, soc, seed=SEED)
    sched = compiled.schedule.to(dev)
    b, s_len = len(WEIGHTS) * N_SEEDS, compiled.n_steps
    cfg = qlearn.QConfig(decay_steps=compiled.n_steps * ITERS)
    grid = [(w, s) for w in WEIGHTS for s in range(N_SEEDS)]
    wb = rewards.stack_weights([w for w, _ in grid], device=dev)
    keys = prng.PRNGKey(np.asarray([SEED + 100003 * s for _, s in grid],
                                   np.uint32), device=dev)
    learned_spec = vec.learned_policy_spec(
        qlearn.init_qstate_batch(cfg, b, dev), sched)
    manual = vec.manual_policy_spec(env.params, sched)
    manual_spec = vec.PolicySpec(
        modes=manual.modes.expand(b, s_len).contiguous(),
        learned=torch.zeros(b, dtype=torch.bool, device=dev),
        qstate=qlearn.QState(*(v.expand(b, *v.shape[1:]).contiguous()
                               for v in manual.qstate)))
    n_tiles, n_thr = soc.n_mem_tiles, compiled.n_threads
    ep_err = 0.0
    ep_plain_ms = None
    packed_main = None
    for ddr, gated, learned in [(False, False, True), (True, True, True),
                                (False, False, False)]:
        spec = learned_spec if learned else manual_spec
        xs, _ = vec.episode_inputs(env.params, sched, spec, cfg, keys,
                                   gated=gated)
        extrema0 = rewards.init_reward_state(soc.n_accs, (b,), dev).extrema
        xf, xi = soc_ref.pack_inputs(xs)
        consts = soc_ref.pack_consts(env.static, spec.learned, wb, b, dev)
        q0 = spec.qstate.qtable.contiguous()
        kq, ky = soc_kernel.soc_step_episode(
            xf, xi, consts, q0, extrema0, n_threads=n_thr, n_tiles=n_tiles,
            n_actions=4, ddr_attribution=ddr, gated=gated)
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        rq, rys = soc_ref.episode_ref(env.static, spec.learned, wb, q0,
                                      extrema0, xs, ddr_attribution=ddr,
                                      gated=gated)
        ev1.record()
        torch.cuda.synchronize()
        if not (ddr or gated) and learned:
            ep_plain_ms = ev0.elapsed_time(ev1)
            packed_main = (xf, xi, consts, q0, extrema0)
        what = f"soc_step_episode vs plain ({ddr=}, {gated=}, {learned=})"
        ep_err = max(ep_err, compare_cols(
            torch, what, soc_ref.YCOLS, ky, torch.stack(
                [c.to(torch.float32) for c in rys], -1),
            ("mode", "state_idx", "action")))
        if not torch.allclose(kq, rq, rtol=TOL, atol=TOL):
            fail(f"{what}: Q-table max abs err "
                 f"{(kq - rq).abs().max().item()}")
        ep_err = max(ep_err, (kq - rq).abs().max().item())
        print(f"{what} B={b} S={s_len}: integer traces equal, max abs err "
              f"{ep_err:.3e} (bound {TOL})")

    # ---- 3. the card equals the CPU plain path on small inputs ------------
    small = dict(iterations=2, seed=SEED, weights=WEIGHTS[:2], n_seeds=2,
                 n_phases=2)
    g_res = orch.train_cohmeleon_batched(soc, device=dev, **small)
    c_res = orch.train_cohmeleon_batched(soc, device="cpu", **small)
    for f in ("visits", "step"):
        if not torch.equal(getattr(g_res.qstates, f).cpu(),
                           getattr(c_res.qstates, f)):
            fail(f"small training: card and CPU {f} differ")
    if not torch.allclose(g_res.qstates.qtable.cpu(), c_res.qstates.qtable,
                          rtol=TOL, atol=TOL):
        fail("small training: card and CPU Q-tables differ")
    print("small training (2 phases, 2 iterations, 4 agents): card == CPU "
          "plain path (visits/steps equal, Q-tables within bound)")

    def small_serve(device):
        s1 = SOCS["SoC1"]
        e = vec.VecEnv(s1, seed=1, device=device)
        app = vec.compile_app(apps.make_application(s1, seed=50,
                                                    n_phases=2), s1, seed=4)
        sc = e._sched(app)
        specs = vec.stack_specs([
            vec.learned_policy_spec(qlearn.init_qstate(device=device), sc),
            vec.fixed_policy_spec(e.params, sc, 0),
            vec.manual_policy_spec(e.params, sc)])
        tspec = traffic.bursty(4e-3, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                               priority=(1.0, 0.25), backoff=400.0,
                               overload_frac=0.35, prio_reserve=0.25, seed=3)
        return vec.ServeEnv(e, queue_cap=4, n_requests=128).serve_specs(
            app, specs, tspec, cfg=qlearn.QConfig(decay_steps=200))

    (gc, gq, gr), (cc, cq, cr) = small_serve(dev), small_serve("cpu")
    for f in vec.ServeResult._fields:
        a, r = getattr(gr, f).cpu(), getattr(cr, f)
        ok = (torch.equal(a, r) if not a.is_floating_point()
              or f in ("retries", "depth")
              else torch.allclose(a, r, rtol=TOL, atol=TOL))
        if not ok:
            fail(f"small serving: card and CPU {f} differ")
    if not (torch.equal(gq.visits.cpu(), cq.visits)
            and torch.equal(gq.step.cpu(), cq.step)):
        fail("small serving: card and CPU visits/steps differ")
    print("small serving (SoC1, 3 policies, 128 requests, overloaded): "
          "card == CPU plain path")

    def small_stacked(device):
        socs = [SOCS["SoC1"], SOCS["SoC2"]]
        st_env = StackedVecEnv(socs, seed=1, device=device)
        st = st_env.compile([apps.make_application(s, seed=7, n_phases=2)
                             for s in socs], seed=3)
        suite = ([pol.FixedHomogeneous(m) for m in CoherenceMode]
                 + [pol.RandomPolicy(), pol.ManualPolicy()])
        return st_env.episodes(st, st_env.lower(st, suite))

    g_ep, c_ep = small_stacked(dev), small_stacked("cpu")
    for f in vec.EpisodeResult._fields:
        a, r = getattr(g_ep, f).cpu(), getattr(c_ep, f)
        ok = (torch.equal(a, r) if not a.is_floating_point()
              else torch.allclose(a, r, rtol=TOL, atol=TOL))
        if not ok:
            fail(f"small stacked episodes: card and CPU {f} differ")
    print("small stacked episodes (SoC1 + SoC2 lanes, 6 policies): card == "
          "CPU plain path")

    # ---- 4. Fig. 6 at full width ------------------------------------------
    counts = {}
    test_app = apps.make_application(soc, seed=TEST_SEED, n_phases=N_PHASES)
    torch.cuda.synchronize()
    soc_ops.reset_launches()
    t_main = time.perf_counter()
    res = orch.train_cohmeleon_batched(
        soc, iterations=ITERS, seed=SEED, weights=WEIGHTS, n_seeds=N_SEEDS,
        n_phases=N_PHASES, env=env)
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    nt, nm = res.evaluate(test_app, seed=TEST_TILE_SEED)
    t_eval = time.perf_counter()
    suite = ([pol.FixedHomogeneous(m) for m in CoherenceMode]
             + [pol.RandomPolicy(), pol.ManualPolicy(), res.qpolicy(0)])
    cmp = orch.compare_policies(env, test_app, suite, seed=TEST_TILE_SEED)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts["fig6"] = (soc_ops.launches, soc_ops.serve_launches)
    expected = ITERS + 2 + 1   # train iterations, baseline + eval, suite
    if counts["fig6"] != (expected, 0):
        fail(f"Fig. 6 launched (episode, serve) {counts['fig6']}, expected "
             f"({expected}, 0)")
    if res.n_agents != b or res.qstates.qtable.shape != (b, 243, 4):
        fail(f"unexpected batch: {tuple(res.qstates.qtable.shape)}")
    if not bool(torch.isfinite(res.qstates.qtable).all()):
        fail("non-finite trained Q-table")
    if not (np.isfinite(nt).all() and np.isfinite(nm).all()):
        fail("non-finite evaluation metrics")
    for name in cmp.policies:
        r = cmp.raw[name]
        if not all(bool(torch.isfinite(v.float()).all()) for v in r):
            fail(f"non-finite episode result for {name}")
    steps = int(res.qstates.step[0])
    if steps != compiled.n_steps * ITERS:
        fail(f"agent 0 took {steps} learning steps, expected "
             f"{compiled.n_steps * ITERS}")
    t_w, m_w = res.per_weight(nt), res.per_weight(nm)
    for (x, y, z), t, m in zip(WEIGHTS, t_w, m_w):
        print(f"fig6 point {x}/{y}/{z}: norm_time={t:.6f} norm_mem={m:.6f}")
    for name in cmp.policies:
        t, m = cmp.geomean(name)
        print(f"suite {name}: norm_time={t:.6f} norm_mem={m:.6f}")
    fig6_s = t_end - t_main
    print(f"fig6 path on {card}: {fig6_s:.3f} s wall (train "
          f"{t_train - t_main:.3f} s, evaluate {t_eval - t_train:.3f} s, "
          f"suite {t_end - t_eval:.3f} s), launches (episode, serve) "
          f"{counts['fig6']}")

    # ---- 5. Fig. 9 at full width ------------------------------------------
    torch.cuda.synchronize()
    soc_ops.reset_launches()
    t9 = time.perf_counter()
    r9 = fig9.run_port(dev)
    torch.cuda.synchronize()
    fig9_s = time.perf_counter() - t9
    counts["fig9"] = (soc_ops.launches, soc_ops.serve_launches)
    e9 = r9["_engine"]
    if counts["fig9"] != (e9["expected_launches"], 0):
        fail(f"Fig. 9 launched (episode, serve) {counts['fig9']}, expected "
             f"({e9['expected_launches']}, 0)")
    if (e9["train_calls"], e9["eval_calls"]) != (1, 1):
        fail(f"Fig. 9 took {e9['train_calls']} training and "
             f"{e9['eval_calls']} evaluation calls, expected 1 and 1")
    for key, row in r9.items():
        if key.startswith("_"):
            continue
        vals = [v for fam in fig9.FAMILIES for v in row[fam]]
        if not all(math.isfinite(v) for v in vals):
            fail(f"Fig. 9 {key}: non-finite metrics")
        print(f"fig9 {key}: " + " ".join(
            f"{fam}=({row[fam][0]:.6f}, {row[fam][1]:.6f})"
            for fam in fig9.FAMILIES))
    h9 = r9["_headline"]
    print(f"fig9 headline: speedup={h9['mean_speedup_vs_fixed']:.6f} "
          f"mem_reduction={h9['mean_mem_reduction_vs_fixed']:.6f}")
    print(f"fig9 path on {card}: {fig9_s:.3f} s wall (train "
          f"{e9['train_s']:.3f} s, profiling {e9['profile_s']:.3f} s in "
          f"{e9['launches_profile']} launches, evaluate "
          f"{e9['evaluate_s']:.3f} s), launches (episode, serve) "
          f"{counts['fig9']}, {e9['lanes']} lanes padded to "
          f"{e9['padded_steps']} steps")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "fig9_port.json").write_text(
        json.dumps(r9, indent=1))

    # ---- 6. Fig. 11 at full width -----------------------------------------
    torch.cuda.synchronize()
    soc_ops.reset_launches()
    t11 = time.perf_counter()
    r11 = fig11.run_port(dev)
    torch.cuda.synchronize()
    fig11_s = time.perf_counter() - t11
    counts["fig11"] = (soc_ops.launches, soc_ops.serve_launches)
    e11 = r11["_engine"]
    want11 = (e11["expected_episode_launches"],
              e11["expected_serve_launches"])
    if counts["fig11"] != want11:
        fail(f"Fig. 11 launched (episode, serve) {counts['fig11']}, "
             f"expected {want11}")
    if not r11["_identity"]["traffic_none_bitwise"]:
        fail("Fig. 11: serving without traffic is not the episode: "
             f"{r11['_identity']['differing']} differ")
    for label, row in r11.items():
        if label.startswith("_"):
            continue
        for name in fig11.POLICIES:
            m = row[name]
            if not all(math.isfinite(m[k]) for k in fig11.METRICS):
                fail(f"Fig. 11 {label} {name}: non-finite metrics")
            print(f"fig11 {label} {name}: served={m['served']} "
                  f"shed={m['offered'] - m['served']} "
                  f"p50={m['p50_latency']:.6g} p99={m['p99_latency']:.6g} "
                  f"degraded_frac={m['degraded_frac']:.6g}")
    if r11["2x"]["cohmeleon"]["shed_frac"] <= 0.0:
        fail("Fig. 11: nothing shed at 2x offered load")
    cap = r11["_capacity"]
    print(f"fig11 capacity: {cap['capacity_per_mcycle']:.6g} requests per "
          f"Mcycle, service {cap['effective_service_cycles']:.6g} cycles")
    print(f"fig11 path on {card}: {fig11_s:.3f} s wall (train "
          f"{e11['train_s']:.3f} s, calibrate {e11['calibrate_s']:.3f} s, "
          f"sweep {e11['sweep_s']:.3f} s), launches (episode, serve) "
          f"{counts['fig11']}")
    (ROOT / "chiprun_out" / "fig11_port.json").write_text(
        json.dumps(r11, indent=1))

    # ---- 7. soc_step_serve vs plain at the Fig. 11 shapes -----------------
    s1 = SOCS["SoC1"]
    env1 = vec.VecEnv(s1, seed=1, device=dev)
    app1 = vec.compile_app(apps.make_application(s1, seed=50, n_phases=8),
                           s1, seed=4)
    sched1 = env1._sched(app1)
    specs1 = vec.stack_specs([
        vec.fixed_policy_spec(env1.params, sched1, 0),
        vec.fixed_policy_spec(env1.params, sched1, 3),
        vec.manual_policy_spec(env1.params, sched1),
        vec.learned_policy_spec(qlearn.init_qstate(device=dev), sched1)])
    cfg1 = qlearn.QConfig(decay_steps=4000)
    svc, n_req = cap["effective_service_cycles"], fig11.N_REQUESTS
    sv_err, sv_plain_ms, sv_packed = 0.0, None, None
    for mult in (0.2, 2.0):
        tspec = fig11._traffic(traffic, mult * cap["capacity_per_mcycle"]
                               * 1e-6, fig11.QUEUE_CAP * svc, 0.25 * svc,
                               device=dev)
        arr = traffic.sample_arrivals(tspec, n_req,
                                      sched1.acc_id.shape[0])
        xs = vec.serve_inputs(env1.params, sched1, specs1, arr,
                              prng.PRNGKey(np.arange(4), device=dev))
        qs0 = specs1.qstate
        carry0 = soc_ref.init_serve_carry(
            qs0.qtable, rewards.init_reward_state(s1.n_accs, (4,),
                                                  dev).extrema,
            s1.n_accs, s1.n_mem_tiles, fig11.QUEUE_CAP, qs0.step)
        sp = vec.serve_params(cfg1, qs0.frozen, tspec)
        xf, xi = soc_ref.pack_inputs(xs)
        consts = soc_ref.pack_serve_consts(env1.static, specs1.learned,
                                           rewards.PAPER_DEFAULT_WEIGHTS, sp,
                                           4, dev)
        rows = [v.expand(4, -1) for v in (arr.t_arr, arr.deadline,
                                          arr.priority)]
        xv = soc_ref.pack_serve_rows(*rows)
        kc, ky = soc_kernel.soc_step_serve(xf, xi, xv, consts, carry0,
                                           n_tiles=s1.n_mem_tiles,
                                           n_actions=4)
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        rc, ry = soc_ref.serve_episode_ref(
            env1.static, specs1.learned, rewards.PAPER_DEFAULT_WEIGHTS, sp,
            carry0, xs, *rows)
        ev1.record()
        torch.cuda.synchronize()
        what = f"soc_step_serve vs plain ({mult:g}x load)"
        sv_err = max(sv_err, compare_cols(torch, what, soc_ref.SERVE_YCOLS,
                                          ky, ry, SERVE_INT_COLS))
        for name in soc_ref.ServeCarry._fields:
            a, r = getattr(kc, name), getattr(rc, name)
            if not torch.allclose(a.float(), r.float(), rtol=TOL, atol=TOL):
                fail(f"{what}: carry {name} differs")
            sv_err = max(sv_err, (a.float() - r.float()).abs().max().item())
        ex = ry[..., soc_ref.SERVE_YCOLS.index("executed")]
        deg = ry[..., soc_ref.SERVE_YCOLS.index("degraded")]
        print(f"{what} B=4 S={n_req}: integer columns equal, max abs err "
              f"{sv_err:.3e} (bound {TOL}); served "
              f"{int(ex.sum())}/{ex.numel()}, degraded steps "
              f"{int(deg.sum())}")
        if mult > 1.0:
            if not (float(ex.mean()) < 1.0 and float(deg.max()) == 1.0):
                fail(f"{what}: the overload neither shed nor tripped the "
                     "watchdog")
            sv_plain_ms = ev0.elapsed_time(ev1)
            sv_packed = (xf, xi, xv, consts, carry0)

    # ---- 8. times and bounds ----------------------------------------------
    xf, xi, consts, q0, extrema0 = packed_main
    run_ep = lambda: soc_kernel.soc_step_episode(
        xf, xi, consts, q0, extrema0, n_threads=n_thr, n_tiles=n_tiles,
        n_actions=4)
    for _ in range(3):
        run_ep()
    torch.cuda.synchronize()
    ep_ms = event_ms(torch, run_ep, 20)
    nf = xf.shape[-1]
    ep_bytes = 4 * (b * s_len * (nf + 5) + b * 25 + 2 * q0.numel()
                    + extrema0.numel() + b * s_len * 6)
    ep_flops = b * s_len * (200 + n_thr * (9 + 5 * n_tiles))
    ep_bytes_ms = ep_bytes / H100_BYTES_PER_S * 1e3
    ep_ops_ms = ep_flops / H100_F32_FLOPS * 1e3
    ep_bound = max(ep_bytes_ms, ep_ops_ms)
    print(f"soc_step_episode on {card}: kernel {ep_ms:.4f} ms/launch "
          f"(B={b}, S={s_len}), plain version {ep_plain_ms:.1f} ms, bound "
          f"{ep_bound:.5f} ms ({ep_bytes} bytes -> {ep_bytes_ms:.5f} ms; "
          f"{ep_flops} f32 ops -> {ep_ops_ms:.5f} ms); serial chain of "
          f"{s_len} dependent steps, {ep_ms / s_len * 1e3:.2f} us/step")

    sxf, sxi, sxv, sconsts, scarry = sv_packed
    run_sv = lambda: soc_kernel.soc_step_serve(
        sxf, sxi, sxv, sconsts, scarry, n_tiles=s1.n_mem_tiles, n_actions=4)
    for _ in range(3):
        run_sv()
    torch.cuda.synchronize()
    sv_ms = event_ms(torch, run_sv, 20)
    carry_bytes = sum(4 * t.numel() for t in scarry)
    # the step reads footprint, u_explore, tiles, profile, avail and the
    # gumbel columns of xf (it makes eps, alpha and the n_accs-wide others
    # block itself) and acc_id and pre_mode of xi
    xf_used = sxf.shape[-1] - 2 - s1.n_accs
    sv_bytes = (4 * (4 * n_req * (xf_used + 2 + sxv.shape[-1]
                                  + len(soc_ref.SERVE_YCOLS))
                     + sconsts.numel())
                + 2 * carry_bytes)
    # per request: four admission attempts over a queue_cap ring, the
    # watchdog, and the fused step over n_accs slots (as for the episode)
    sv_flops = 4 * n_req * (4 * (fig11.QUEUE_CAP + 4) + 30
                            + 200 + s1.n_accs * (9 + 5 * s1.n_mem_tiles))
    sv_bytes_ms = sv_bytes / H100_BYTES_PER_S * 1e3
    sv_ops_ms = sv_flops / H100_F32_FLOPS * 1e3
    sv_bound = max(sv_bytes_ms, sv_ops_ms)
    print(f"soc_step_serve on {card}: kernel {sv_ms:.4f} ms/launch "
          f"(B=4, S={n_req}), plain version {sv_plain_ms:.1f} ms, bound "
          f"{sv_bound:.6f} ms ({sv_bytes} bytes -> {sv_bytes_ms:.6f} ms; "
          f"{sv_flops} f32 ops -> {sv_ops_ms:.6f} ms); serial chain of "
          f"{n_req} dependent requests, {sv_ms / n_req * 1e3:.2f} "
          f"us/request; library_ms null for both kernels (no single "
          f"PyTorch call computes either step)")
    print(f"paths on {card}: fig6 {fig6_s:.3f} s, fig9 {fig9_s:.3f} s, "
          f"fig11 {fig11_s:.3f} s")

    paths_s = {"fig6": fig6_s, "fig9": fig9_s, "fig11": fig11_s}
    # launches: the sum over the paths; main_path_s: the summed wall time
    # of the paths that launched the kernel
    by_path = lambda j: {p: c[j] for p, c in counts.items()}
    on_paths = lambda j: sum(paths_s[p] for p, c in counts.items() if c[j])
    kernels = {"kernels": [
        {"name": "soc_step_episode", "route": "cuda",
         "source": "src/repro_torch/kernels/soc_step/csrc/soc_step.cu",
         "replaces": "src/repro/kernels/soc_step/kernel.py:113",
         "tpu": "kernels/soc_step/kernel.py:113",
         "launches": sum(c[0] for c in counts.values()),
         "launches_by_path": by_path(0), "max_abs_err": ep_err,
         "ms": ep_ms, "plain_ms": ep_plain_ms, "bound_ms": ep_bound,
         "bound_by": "bytes" if ep_bytes_ms >= ep_ops_ms else "operations",
         "library_ms": None, "main_path_s": on_paths(0),
         "shape": f"B={b} S={s_len}", "card": card},
        {"name": "soc_step_serve", "route": "cuda",
         "source": "src/repro_torch/kernels/soc_step/csrc/soc_step.cu",
         "replaces": "src/repro/kernels/soc_step/kernel.py:258",
         "tpu": "kernels/soc_step/kernel.py:258",
         "launches": sum(c[1] for c in counts.values()),
         "launches_by_path": by_path(1), "max_abs_err": sv_err,
         "ms": sv_ms, "plain_ms": sv_plain_ms, "bound_ms": sv_bound,
         "bound_by": "bytes" if sv_bytes_ms >= sv_ops_ms else "operations",
         "library_ms": None, "main_path_s": on_paths(1),
         "shape": f"B=4 S={n_req}", "card": card},
    ], "paths_s": paths_s}
    for k in kernels["kernels"]:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                  "bound_ms")):
            fail(f"{k['name']}: non-finite timing")
    if counts["fig11"][1] == 0 or any(c[0] == 0 for c in counts.values()):
        fail(f"a path did not launch its kernels: {counts}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
