"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version at the main path's shapes, drives the
main path once at full width — the Fig. 6 reward sweep on SOC_MOTIV_PAR:
15 reward weightings x 8 seeds = 120 agents trained for 10 iterations of
a 540-step application in one batched call per iteration, then the frozen
evaluation against Fixed NON_COH and the 7-policy comparison in one call
— checks that the path launched the kernel the expected number of times
and that its outputs are finite and agree with the CPU plain path on a
small input, and times the kernel, its plain version and the whole path.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists every ported
kernel with its numbers.
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


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np
        from repro_torch import random as prng
        from repro_torch.core import orchestrator as orch
        from repro_torch.core import policies as pol
        from repro_torch.core import qlearn, rewards
        from repro_torch.core.modes import CoherenceMode
        from repro_torch.kernels.soc_step import kernel as soc_kernel
        from repro_torch.kernels.soc_step import ops as soc_ops
        from repro_torch.kernels.soc_step import ref as soc_ref
        from repro_torch.soc import apps, vecenv as vec
        from repro_torch.soc.config import SOC_MOTIV_PAR
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

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = soc_kernel.build(verbose=True)
    print(f"build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- 2. kernel vs plain version at the main path's shapes -------------
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
    max_abs_err = 0.0
    plain_ms = None
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
            plain_ms = ev0.elapsed_time(ev1)
            packed_main = (xf, xi, consts, q0, extrema0)
        kys = soc_ref.unpack_ys(ky)
        for name, a, r in zip(soc_ref.YCOLS, kys, rys):
            if a.dtype == torch.int32:
                if not torch.equal(a, r):
                    bad = (a != r).nonzero()[0].tolist()
                    fail(f"kernel vs plain ({ddr=}, {gated=}, {learned=}): "
                         f"{name} differs first at [episode, step] {bad}: "
                         f"kernel {a[bad[0], bad[1]].item()} plain "
                         f"{r[bad[0], bad[1]].item()}")
            else:
                if not torch.allclose(a, r, rtol=TOL, atol=TOL):
                    fail(f"kernel vs plain ({ddr=}, {gated=}, {learned=}): "
                         f"{name} max abs err "
                         f"{(a - r).abs().max().item()}")
                max_abs_err = max(max_abs_err, (a - r).abs().max().item())
        if not torch.allclose(kq, rq, rtol=TOL, atol=TOL):
            fail(f"kernel vs plain ({ddr=}, {gated=}, {learned=}): "
                 f"Q-table max abs err {(kq - rq).abs().max().item()}")
        max_abs_err = max(max_abs_err, (kq - rq).abs().max().item())
        print(f"kernel vs plain ddr={ddr} gated={gated} learned={learned} "
              f"B={b} S={s_len}: integer traces equal, max abs err "
              f"{max_abs_err:.3e} (bound {TOL})")

    # ---- 3. the main path agrees with the CPU plain path on a small input
    small = dict(iterations=2, seed=SEED, weights=WEIGHTS[:2], n_seeds=2,
                 n_phases=2)
    g_res = orch.train_cohmeleon_batched(soc, device=dev, **small)
    c_res = orch.train_cohmeleon_batched(soc, device="cpu", **small)
    for f in ("visits", "step"):
        if not torch.equal(getattr(g_res.qstates, f).cpu(),
                           getattr(c_res.qstates, f)):
            fail(f"small slice: card and CPU {f} differ")
    if not torch.allclose(g_res.qstates.qtable.cpu(), c_res.qstates.qtable,
                          rtol=TOL, atol=TOL):
        fail("small slice: card and CPU Q-tables differ")
    print("small slice (2 phases, 2 iterations, 4 agents): card == CPU "
          "plain path (visits/steps equal, Q-tables within bound)")

    # ---- 4. the main path at full width -----------------------------------
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
    launches = soc_ops.launches
    expected = ITERS + 2 + 1   # train iterations, baseline + eval, suite
    if launches != expected:
        fail(f"main path launched the kernel {launches} times, expected "
             f"{expected}")
    if res.n_agents != 120 or res.qstates.qtable.shape != (120, 243, 4):
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
    main_s = t_end - t_main
    print(f"main path on {card}: {main_s:.3f} s wall (train "
          f"{t_train - t_main:.3f} s, evaluate {t_eval - t_train:.3f} s, "
          f"suite {t_end - t_eval:.3f} s), {launches} kernel launches")

    # ---- 5. times ---------------------------------------------------------
    xf, xi, consts, q0, extrema0 = packed_main
    run = lambda: soc_kernel.soc_step_episode(
        xf, xi, consts, q0, extrema0, n_threads=n_thr, n_tiles=n_tiles,
        n_actions=4)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    reps = 20
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(reps):
        run()
    ev1.record()
    torch.cuda.synchronize()
    kernel_ms = ev0.elapsed_time(ev1) / reps
    nf = xf.shape[-1]
    n_bytes = 4 * (b * s_len * (nf + 5) + b * 25 + 2 * q0.numel()
                   + extrema0.numel() + b * s_len * 6)
    flops_per_step = 200 + n_thr * (9 + 5 * n_tiles)
    n_flops = b * s_len * flops_per_step
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_flops / H100_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"soc_step_episode on {card}: kernel {kernel_ms:.4f} ms/launch "
          f"(B={b}, S={s_len}), plain version {plain_ms:.1f} ms, bound "
          f"{bound_ms:.5f} ms ({n_bytes} bytes -> {bytes_ms:.5f} ms; "
          f"{n_flops} f32 ops -> {ops_ms:.5f} ms); serial chain of "
          f"{s_len} dependent steps, {kernel_ms / s_len * 1e3:.2f} us/step; "
          f"library_ms null (no single PyTorch call computes this step)")

    kernels = {"kernels": [{
        "name": "soc_step_episode", "route": "cuda",
        "source": "src/repro_torch/kernels/soc_step/csrc/soc_step.cu",
        "replaces": "src/repro/kernels/soc_step/kernel.py:113",
        "tpu": "kernels/soc_step/kernel.py:113",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "main_path_s": main_s, "card": card}]}
    if not all(math.isfinite(v) for v in (kernel_ms, plain_ms, bound_ms)):
        fail("non-finite timing")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
