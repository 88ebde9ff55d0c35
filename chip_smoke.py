"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, one ``nvcc`` per
source, started together (``soc_step.cu``: ``soc_step_episode`` and
``soc_step_serve``, each in a healthy and a faulted instantiation, and the
episode kernel's MLP instantiations, healthy and faulted;
``flash_attention.cu``: K3; ``rwkv6_scan.cu``: K5; ``moe_gmm.cu``: K4;
``rglru_scan.cu``: K6), and holds each
against its plain PyTorch version at the shapes its paths give it; checks the card against the CPU
plain path on small inputs (batched training, serving, stacked episodes
on 2 lanes, each also under a fault storm, a killed and resumed
checkpointed training and serving run, and MLP portfolio training); then
drives six paths at
full width, each with the launch counts set to 0 just before it and read
just after:

  * Fig. 6, the reward sweep on SOC_MOTIV_PAR: 15 weightings x 8 seeds =
    120 agents trained for 10 iterations of a 540-step app, one launch per
    iteration, then frozen evaluation and the 7-policy comparison;
  * Fig. 9, eight Table-4 SoC lanes (``benchmarks/torch_fig9_socs.py``):
    stacked training, profiled heterogeneous baselines, every policy
    family on every lane in one launch;
  * Fig. 11, always-on serving on SoC1 (``benchmarks/
    torch_fig11_serving.py``): training, capacity calibration, four
    policies serving 1,024 requests at five offered loads;
  * Fig. 10, robustness under injected faults on SoC1 (``benchmarks/
    torch_fig10_faults.py``): an agent trained and six policies evaluated
    inside a fault storm at four intensities (healthy, 0.25, 0.5, 1.0);
  * storm serving: four policies serving 1,024 requests at Fig. 11's
    capacity under ``storm(1024, 0.7, PRNGKey(42))``;
  * Fig. 13, held-out generalization (``benchmarks/
    torch_fig13_generalize.py``): one MLP Q-network trained by federated
    averaging over 8 DSE-sampled SoCs and a shared Q-table on the same
    episodes, both scored on held-out apps and held-out SoCs.

Then it holds the flash-attention kernel (K3) against its plain version
at the Qwen3 and granite serving paths' prefill and decode shapes, at
every feature case of ``tests/test_kernels.py`` in float32 and bfloat16,
and at a Gemma-2-shaped case, each call through the body its plan names
(``tc_prefill``, ``split_decode`` or ``fp32_prefill``) and bitwise equal
to a second launch; runs the coverage probe (q = 0, a one-hot v: every
key seen exactly where the mask says) of the tensor-core prefill at the
Qwen3, granite, recurrentgemma and Gemma-2 local prefill shapes and of
the split decode at their decode shapes with 1, 4 and 7 query rows (over
cache slices whose later rows hold v = 1), beside a check with q four
times larger that each decode row gets its own head's output; times the
float32 decode through ``split_decode`` and through ``fp32_prefill``;
counts the HGMMA instructions of the tensor-core bodies in the built
library (``cuobjdump -sass``) and fails on none; checks the card against
the CPU on the Qwen3 smoke serve; and drives a seventh path:

  * Qwen3-8B serving at full width (``repro_torch.launch.serve``): random
    float32 weights made on the card from a seed, 4 prompts of 2,048
    tokens prefilled and 32 tokens decoded greedily, bf16 compute, every
    attention through K3 (36 prefill launches through ``tc_prefill``, 36 x
    32 decode launches through ``split_decode``, asserted).

Then it holds the RWKV-6 scan kernel (K5) against its plain step-by-step
version at the rwkv6-3b prefill's shape, from a zero and a random state,
at ``tests/test_kernels.py``'s shapes and on its two-halves state
composition; checks the card against the CPU on the rwkv6 smoke serve
(float32, the reference's zero-initialised ``u``, LoRA-b and ``ln_w`` set
from a seed); and drives an eighth path:

  * rwkv6-3b serving at full width: random float32 weights made on the
    card from a seed, the same 4 prompts of 2,048 tokens and 32 greedy
    tokens, bf16 compute; every time mix of the prefill through K5 (32
    launches), decode through the model's step function, K3 never.

Then it holds the grouped expert-matmul kernel (K4) against its plain
version at the granite serving path's prefill (gate/up and down) and
decode shapes and at ``tests/test_kernels.py``'s shapes, in float32 and
bf16, with every row past its group's size exactly 0; checks the card
against the CPU on the granite smoke serve (float32); and drives a ninth
path:

  * granite-moe-3b-a800m serving at full width: random float32 weights
    made on the card from a seed, the same 4 prompts of 2,048 tokens and
    32 greedy tokens, bf16 compute; every attention through K3 (32
    ``tc_prefill`` and 32 x 32 ``split_decode`` launches) and every expert
    product through K4 (3 x 32 x 33), K5 never; it prints the prefill's
    mean drop_frac and the smallest top-k margin the router saw.

Then it holds the RG-LRU scan kernel (K6) against its plain step-by-step
version at the recurrentgemma-9b prefill's shape, from a zero and a
random initial state, and at ``tests/test_kernels.py``'s shapes; holds K3
at that path's prefill and decode shapes (head dim 256, one kv head,
window 2,048), in bf16 and float32; checks the card against the CPU on
the recurrentgemma smoke serve (float32, the reference's zero biases,
norms and constant ``lam`` set from a seed, rings that wrap); and drives
a tenth path:

  * recurrentgemma-9b serving at full width: random float32 weights made
    on the card from a seed, the same 4 prompts of 2,048 tokens and 32
    greedy tokens, bf16 compute (the RG-LRU blocks in float32); every
    RG-LRU prefill through K6 (26 launches) and every local attention
    through K3 (12 ``tc_prefill`` and 12 x 32 ``split_decode`` launches),
    decode's recurrence through the model's step function.

The faulted MLP instantiation runs on no path (the reference runs MLP
agents under faults in no figure); it is held against its plain version
and reported with 0 launches.

It checks each path's kernel launch counts and finite outputs, prints the
paths' headline numbers and wall times, and times each kernel, its plain
version, its bound and, for K3 (at the Qwen3, granite and recurrentgemma
prefill and decode shapes, as 20 launches in a row, the ``ms`` of every
kernel, and as the device time of a CUDA graph of 20 launches), PyTorch's
``scaled_dot_product_attention`` on the same inputs, for K4 cuBLAS's
dense batched product over the whole buffer (no single PyTorch call
computes the SoC step, the WKV or the RG-LRU recurrence).  Exits non-zero,
printing no result, without a CUDA card or outside a checkout of the
repository.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it lists
every ported kernel with its numbers.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# per path: launches of (K1 episode, K2 serve, K1f faulted episode, K2f
# faulted serve, K1m MLP episode, K1m faulted, K3 flash attention, K5
# RWKV-6 scan, K4 grouped expert matmul, K6 RG-LRU scan)
KERNELS = ("soc_step_episode", "soc_step_serve", "soc_step_episode_faulted",
           "soc_step_serve_faulted", "soc_step_episode_mlp",
           "soc_step_episode_mlp_faulted", "flash_attention", "rwkv6_scan",
           "moe_gmm", "rglru_scan")
SOC_KERNELS = KERNELS[:6]
# held against their plain versions only: no path of the reference runs
# an MLP agent under faults
OFF_PATH = ("soc_step_episode_mlp_faulted",)
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak
# K3 at the serving path's shapes, (B, H, Hkv, Sq, Skv, hd): prefill of a
# 2,048-token prompt; decode at the first generated token, over a cache
# of 2,080 rows (prompt + 32 generated)
QWEN_BATCH, QWEN_PROMPT, QWEN_GEN = 4, 2048, 32
FA_PREFILL = (QWEN_BATCH, 32, 8, QWEN_PROMPT, QWEN_PROMPT, 128)
FA_DECODE = (QWEN_BATCH, 32, 8, 1, QWEN_PROMPT + 1, 128,
             QWEN_PROMPT + QWEN_GEN)
# tests/test_kernels.py's flash-attention cases and tolerances
FA_SHAPES = [(1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 64),
             (1, 4, 1, 256, 256, 128), (1, 2, 2, 128, 384, 64)]
FA_FEATS = [dict(causal=True), dict(causal=True, window=64),
            dict(causal=True, softcap=50.0), dict(causal=False)]
LM_TOL = 1e-5                 # card vs CPU logits, tests/test_torch_lm.py
# K5 at the rwkv6-3b prefill's shape (B, H, T, K): B*H = 160
RWKV_SCAN = (QWEN_BATCH, 40, QWEN_PROMPT, 64)
# tests/test_kernels.py's scan shapes and its state-composition case
RWKV_SHAPES = [(1, 2, 32, 16), (2, 4, 64, 32), (1, 1, 128, 64)]
RWKV_COMPOSE = (1, 2, 64, 16)
# K4 at the granite-moe-3b-a800m serving path's shapes (B, E, C, D, F):
# the prefill's gate/up and down products (capacity 432 rows of the 48
# padded experts, 40 routed) and a decode step's gate/up (capacity 8, at
# most one row per group)
GMM_PREFILL = (QWEN_BATCH, 48, 432, 1536, 512)
GMM_DOWN = (QWEN_BATCH, 48, 432, 512, 1536)
GMM_DECODE = (QWEN_BATCH, 48, 8, 1536, 512)
GMM_REAL = 40
# tests/test_kernels.py's grouped-matmul shapes (E, C, D, F) and its bf16
# tolerance
GMM_SHAPES = [(4, 64, 128, 96), (8, 32, 64, 64), (2, 128, 256, 128)]
GMM_BF16_TOL = dict(rtol=5e-2, atol=5e-1)
# K6 at the recurrentgemma-9b prefill's shape (B, T, W), tests/
# test_kernels.py's rglru shapes and tolerance; K3 at that path's prefill
# (16 query heads on one kv head of 256, window 2048) and decode (one row
# over the full 2,048-row ring) shapes
RG_SCAN = (QWEN_BATCH, QWEN_PROMPT, 4096)
RG_SHAPES = [(2, 128, 32), (1, 256, 64), (3, 64, 16)]
RG_TOL = 1e-5
RG_WINDOW = 2048
FA_RG_PREFILL = (QWEN_BATCH, 16, 1, QWEN_PROMPT, QWEN_PROMPT, 256)
FA_RG_DECODE = (QWEN_BATCH, 16, 1, 1, RG_WINDOW, 256)
# K3 at the granite-moe-3b-a800m serving path's shapes: 24 query heads over
# 8 kv heads of 64, the same prompt and cache as Qwen3's
FA_GR_PREFILL = (QWEN_BATCH, 24, 8, QWEN_PROMPT, QWEN_PROMPT, 64)
FA_GR_DECODE = (QWEN_BATCH, 24, 8, 1, QWEN_PROMPT + 1, 64,
                QWEN_PROMPT + QWEN_GEN)
# every bf16 K3 launch on an LM path goes through one of these bodies
FA_BF16_BODIES = ("tc_prefill", "split_decode")


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


class _Crash(Exception):
    """A simulated crash of a checkpointed run."""


class _Killer:
    """A checkpoint manager that dies before its ``die_after + 1``-th
    save, as a killed host would."""

    def __init__(self, inner, die_after: int):
        self._inner, self._left = inner, die_after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, step, tree):
        if self._left <= 0:
            raise _Crash(f"simulated crash before checkpoint {step}")
        self._left -= 1
        self._inner.save(step, tree)
        self._inner.wait()


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
        import torch.nn.functional as F
        from benchmarks import torch_fig9_socs as fig9
        from benchmarks import torch_fig10_faults as fig10
        from benchmarks import torch_fig11_serving as fig11
        from benchmarks import torch_fig13_generalize as fig13
        from repro_torch import random as prng
        from repro_torch.configs import get_arch, smoke_config
        from repro_torch.kernels import nvcc
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel
        from repro_torch.kernels.rwkv6_scan import ops as rw_ops
        from repro_torch.kernels.rwkv6_scan import ref as rw_ref
        from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
        from repro_torch.kernels.moe_gmm import ops as gmm_ops
        from repro_torch.kernels.moe_gmm import ref as gmm_ref
        from repro_torch.kernels.rglru_scan import kernel as rg_kernel
        from repro_torch.kernels.rglru_scan import ops as rg_ops
        from repro_torch.kernels.rglru_scan import ref as rg_ref
        from repro_torch.models import mlp as lm_mlp
        from repro_torch.launch import serve as lm_serve
        from repro_torch.models import transformer as lm
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.core import orchestrator as orch
        from repro_torch.core import policies as pol
        from repro_torch.core import qlearn, rewards
        from repro_torch.core.modes import CoherenceMode
        from repro_torch.kernels.soc_step import kernel as soc_kernel
        from repro_torch.kernels.soc_step import ops as soc_ops
        from repro_torch.kernels.soc_step import ref as soc_ref
        from repro_torch.soc import apps, faults, traffic, vecenv as vec
        from repro_torch.soc import dse, nn as socnn
        from repro_torch.soc.config import SOC_MOTIV_PAR, SOCS
        from repro_torch.soc.stacked import StackedVecEnv
    except ImportError as e:
        fail(f"the repro_torch package is not in this checkout ({e})")

    dev = torch.device("cuda")
    card = card_line()
    nvcc_version = subprocess.run([nvcc.find_nvcc(), "--version"],
                                  capture_output=True, text=True).stdout
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"nvcc {nvcc_version.strip().splitlines()[-1]}")
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build: one nvcc per source, all started together -------------
    def timed_build(mod):
        t = time.perf_counter()
        lib = mod.build(verbose=True)
        return lib, time.perf_counter() - t

    t0 = time.perf_counter()
    sources = (soc_kernel, fa_kernel, rw_kernel, gmm_kernel, rg_kernel)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = [pool.submit(timed_build, m) for m in sources]
        for f in builds:
            lib, secs = f.result()
            print(f"build: {lib.relative_to(ROOT)} in {secs:.2f} s")
    print(f"builds: {time.perf_counter() - t0:.2f} s for all five")
    # K3's tensor-core bodies must compile to warpgroup MMAs (HGMMA)
    sass = subprocess.run(
        [str(Path(nvcc.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(fa_kernel.build())], capture_output=True, text=True)
    if sass.returncode != 0:
        fail(f"cuobjdump: {sass.stderr.strip()}")
    hgmma, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            hgmma[fn] = 0
        elif fn is not None and "HGMMA" in line:
            hgmma[fn] += 1
    hgmma_by_body = {}
    for body in ("tc_prefill_kernel", "tc_decode_kernel"):
        for hd in (64, 128, 256):
            mangled = [f for f in hgmma if f"{body}ILi{hd}E" in f]
            if len(mangled) != 1:
                fail(f"flash_attention library: no single {body}<{hd}> in "
                     f"{sorted(hgmma)}")
            n = hgmma[mangled[0]]
            hgmma_by_body[f"{body}<{hd}>"] = n
            if n == 0:
                fail(f"flash_attention {body}<{hd}> has no HGMMA")
    print(f"flash_attention HGMMA instructions in the SASS: {hgmma_by_body}")

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

    def episode_vs_plain(what, e, spec, w, xs, ddr=False, gated=False):
        """The episode kernel (its faulted instantiation when ``xs`` has
        fault columns, its MLP one for an MLP spec) against
        ``ref.episode_ref`` on the same inputs; returns ``(max abs err,
        plain ms, packed kernel arguments, kernel outputs)``."""
        n = spec.learned.shape[0]
        extrema0 = rewards.init_reward_state(e.soc.n_accs, (n,),
                                             dev).extrema
        mlp = spec.mlp
        xf, xi = soc_ref.pack_inputs(xs)
        consts = soc_ref.pack_consts(
            e.static, spec.learned, w, n, dev,
            *(() if mlp is None else (spec.qfun, mlp.lr)))
        q0 = spec.qstate.qtable.contiguous()
        kw = dict(n_threads=xs.others.shape[-1], n_tiles=xs.tiles.shape[-1],
                  n_actions=4, ddr_attribution=ddr, gated=gated,
                  faulted=xs.faulted)
        args = (xf, xi, consts, q0, extrema0)
        mkw = {}
        if mlp is not None:
            args += (mlp.wpack.contiguous(),)
            kw.update(mlp_dims=socnn.mlp_dims(mlp.cfg),
                      mlp_feats=mlp.cfg.features)
            mkw = dict(wpack0=mlp.wpack, qfun=spec.qfun, mlp_lr=mlp.lr,
                       mlp_dims=kw["mlp_dims"], mlp_feats=kw["mlp_feats"])
        out = soc_kernel.soc_step_episode(*args, **kw)
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        plain = soc_ref.episode_ref(e.static, spec.learned, w, q0, extrema0,
                                    xs, ddr_attribution=ddr, gated=gated,
                                    **mkw)
        ev1.record()
        torch.cuda.synchronize()
        err = compare_cols(torch, what, soc_ref.YCOLS, out[-1], torch.stack(
            [c.to(torch.float32) for c in plain[-1]], -1),
            ("mode", "state_idx", "action"))
        for label, a, r in zip(("Q-table", "weight pack"), out[:-1],
                               plain[:-1]):
            if not torch.allclose(a, r, rtol=TOL, atol=TOL):
                fail(f"{what}: {label} max abs err "
                     f"{(a - r).abs().max().item()}")
            err = max(err, (a - r).abs().max().item())
        print(f"{what} B={n} S={xs.acc_id.shape[1]}: integer traces equal, "
              f"max abs err {err:.3e} (bound {TOL})")
        return err, ev0.elapsed_time(ev1), (args, kw), out

    ep_err = 0.0
    for ddr, gated, learned in [(False, False, True), (True, True, True),
                                (False, False, False)]:
        spec = learned_spec if learned else manual_spec
        xs, _ = vec.episode_inputs(env.params, sched, spec, cfg, keys,
                                   gated=gated)
        err, ms, packed, _ = episode_vs_plain(
            f"soc_step_episode vs plain ({ddr=}, {gated=}, {learned=})",
            env, spec, wb, xs, ddr, gated)
        ep_err = max(ep_err, err)
        if not (ddr or gated) and learned:
            ep_plain_ms, packed_main = ms, packed

    # ---- 2b. the faulted episode kernel (K1f) vs plain: Fig. 6's shape
    # under the severe storm, and Fig. 10's evaluation (6 policies) -------
    storm6 = faults.storm(s_len, 1.0, prng.PRNGKey(42), device=dev)
    xs, _ = vec.episode_inputs(env.params, sched, learned_spec, cfg, keys,
                               faults=storm6)
    epf_err, epf_plain_ms, packed_f, _ = episode_vs_plain(
        "soc_step_episode_faulted vs plain (storm 1.0)", env, learned_spec,
        wb, xs)
    if torch.equal(xs.f_exec, torch.ones_like(xs.f_exec)):
        fail("the severe storm left every step healthy")
    s1 = SOCS["SoC1"]
    env1 = vec.VecEnv(s1, seed=1, device=dev)
    app1 = vec.compile_app(apps.make_application(s1, seed=50, n_phases=8),
                           s1, seed=4)
    sched1 = env1._sched(app1)
    specs10 = vec.stack_specs(
        [vec.fixed_policy_spec(env1.params, sched1, int(m))
         for m in CoherenceMode]
        + [vec.manual_policy_spec(env1.params, sched1),
           vec.learned_policy_spec(qlearn.frozen_qstate(device=dev),
                                   sched1)])
    xs, _ = vec.episode_inputs(
        env1.params, sched1, specs10, qlearn.QConfig(),
        prng.PRNGKey(np.arange(6), device=dev),
        faults=faults.storm(app1.n_steps, 1.0, prng.PRNGKey(42),
                            device=dev))
    err, _, _, _ = episode_vs_plain(
        "soc_step_episode_faulted vs plain (Fig. 10 evaluation, storm 1.0)",
        env1, specs10, rewards.PAPER_DEFAULT_WEIGHTS, xs)
    epf_err = max(epf_err, err)

    # ---- 2c. the MLP episode kernel (K1m) vs plain at Fig. 6's shape: 120
    # learning sense networks (qfun, lr 0.05); a frozen one-hot network
    # distilled from K1's trained tables, whose modes must be K1's; and
    # the faulted MLP instantiation under the severe storm -----------------
    mlp_spec = vec.mlp_policy_spec(socnn.init_mlp_qstate(keys), sched)
    xs, _ = vec.episode_inputs(env.params, sched, mlp_spec, cfg, keys)
    epm_err, epm_plain_ms, packed_m, (_, mw, _) = episode_vs_plain(
        "soc_step_episode_mlp vs plain (sense (14, 16, 16, 4), learning)",
        env, mlp_spec, wb, xs)
    if torch.equal(mw, mlp_spec.mlp.wpack):
        fail("the learning networks did not change")
    (xf, xi, consts, q0, extrema0), kw = packed_main
    trained, _ = soc_kernel.soc_step_episode(xf, xi, consts, q0, extrema0,
                                             **kw)
    frozen_q = qlearn.freeze(learned_spec.qstate._replace(qtable=trained))
    tspec = vec.learned_policy_spec(frozen_q, sched)
    xs, _ = vec.episode_inputs(env.params, sched, tspec, cfg, keys)
    _, _, _, (_, ty) = episode_vs_plain(
        "soc_step_episode vs plain (frozen trained tables)", env, tspec, wb,
        xs)
    oh_spec = vec.mlp_policy_spec(
        socnn.freeze(socnn.mlp_from_qtable(trained)), sched)
    xs_oh, _ = vec.episode_inputs(env.params, sched, oh_spec, cfg, keys)
    err, _, _, (_, ow, oy) = episode_vs_plain(
        "soc_step_episode_mlp vs plain (one-hot (243, 4) from the trained "
        "tables, frozen)", env, oh_spec, wb, xs_oh)
    epm_err = max(epm_err, err)
    if not (torch.equal(oy[..., :3], ty[..., :3])
            and torch.equal(ow, oh_spec.mlp.wpack)):
        fail("the one-hot network distilled from the tables does not select "
             "the tables' modes")
    print("soc_step_episode_mlp (one-hot from the tables): modes, states "
          "and actions equal to soc_step_episode's on the same tables")
    xs, _ = vec.episode_inputs(env.params, sched, mlp_spec, cfg, keys,
                               faults=storm6)
    epmf_err, epmf_plain_ms, packed_mf, _ = episode_vs_plain(
        "soc_step_episode_mlp_faulted vs plain (storm 1.0)", env, mlp_spec,
        wb, xs)

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

    def small_serve(device, storm):
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
        fs = (faults.storm(128, 0.7, prng.PRNGKey(42), device=device)
              if storm else None)
        return vec.ServeEnv(e, queue_cap=4, n_requests=128).serve_specs(
            app, specs, tspec, cfg=qlearn.QConfig(decay_steps=200),
            faults=fs)

    def same_tree(what, got, want, exact_float=()):
        """Integer leaves equal, floats within TOL (or equal when named
        in ``exact_float``)."""
        for f in want._fields:
            a, r = getattr(got, f).cpu(), getattr(want, f).cpu()
            ok = (torch.equal(a, r) if not a.is_floating_point()
                  or f in exact_float
                  else torch.allclose(a, r, rtol=TOL, atol=TOL))
            if not ok:
                fail(f"{what}: {f} differs")

    for storm in (False, True):
        (gc, gq, gr), (cc, cq, cr) = (small_serve(dev, storm),
                                      small_serve("cpu", storm))
        tag = " under storm 0.7" if storm else ""
        same_tree(f"small serving{tag}: card vs CPU", gr, cr,
                  ("retries", "depth"))
        same_tree(f"small serving{tag}: card vs CPU", gq, cq)
        print(f"small serving (SoC1, 3 policies, 128 requests, "
              f"overloaded){tag}: card == CPU plain path")

    def small_stacked(device, storm):
        socs = [SOCS["SoC1"], SOCS["SoC2"]]
        st_env = StackedVecEnv(socs, seed=1, device=device)
        st = st_env.compile([apps.make_application(s, seed=7, n_phases=2)
                             for s in socs], seed=3)
        suite = ([pol.FixedHomogeneous(m) for m in CoherenceMode]
                 + [pol.RandomPolicy(), pol.ManualPolicy()])
        fs = (faults.storm(st.schedule.acc_id.shape[-1], 0.7,
                           prng.PRNGKey(42), device=device)
              if storm else None)
        return st_env.episodes(st, st_env.lower(st, suite), faults=fs)

    for storm in (False, True):
        tag = " under storm 0.7" if storm else ""
        same_tree(f"small stacked episodes{tag}: card vs CPU",
                  small_stacked(dev, storm), small_stacked("cpu", storm))
        print(f"small stacked episodes (SoC1 + SoC2 lanes, 6 policies)"
              f"{tag}: card == CPU plain path")

    def small_storm_setup(device):
        e = vec.VecEnv(s1, seed=1, device=device)
        app = apps.make_application(s1, seed=0, n_phases=2)
        train = [vec.compile_app(app, s1, seed=it) for it in range(2)]
        ev = vec.compile_app(apps.make_application(s1, seed=50, n_phases=2),
                             s1, seed=4)
        cfg_s = qlearn.QConfig(decay_steps=2 * train[0].n_steps,
                               collapse_frac=0.25)
        fs = faults.storm(ev.n_steps, 1.0, prng.PRNGKey(42), device=device)
        args = (train, cfg_s, rewards.stack_weights(WEIGHTS[:2]),
                prng.PRNGKey(np.arange(2)))
        return e, args, ev, fs

    def small_storm_train(device):
        e, args, ev, fs = small_storm_setup(device)
        return e.train_batched(*args, eval_app=ev, faults=fs)

    (g_qs, g_h), (c_qs, c_h) = (small_storm_train(dev),
                                small_storm_train("cpu"))
    same_tree("small storm training: card vs CPU", g_qs, c_qs)
    if not all(torch.allclose(a.cpu(), r, rtol=TOL, atol=TOL)
               for a, r in zip(g_h, c_h)):
        fail("small storm training: card and CPU histories differ")
    print("small storm training (SoC1, 2 agents, 2 iterations, storm 1.0): "
          "card == CPU plain path")

    def small_portfolio(device):
        items = [(vec.VecEnv(sp.config, seed=0, device=device),
                  [fig13._compile(vec, apps.make_application, sp.config,
                                  sp.seed + d, 2) for d in (0, 1)])
                 for sp in dse.sample_socs(0, 2)]
        return socnn.train_portfolio(
            items, qlearn.QConfig(decay_steps=2048), iterations=2, batch=2,
            key=prng.PRNGKey(1, device=device))

    (g_mlp, g_hist), (c_mlp, c_hist) = (small_portfolio(dev),
                                        small_portfolio("cpu"))
    for f in ("wpack", "lr", "step", "frozen"):
        a, r = getattr(g_mlp, f).cpu(), getattr(c_mlp, f)
        if not (torch.allclose(a, r, rtol=TOL, atol=TOL)
                if a.is_floating_point() else torch.equal(a, r)):
            fail(f"small portfolio training: card and CPU {f} differ")
    if not torch.allclose(g_hist, c_hist, rtol=TOL, atol=TOL):
        fail("small portfolio training: card and CPU histories differ")
    print("small portfolio training (2 DSE SoCs, 2 iterations of 2 "
          "episodes): card == CPU plain path")

    # kill-and-resume of the checkpointed training and serving on the card
    ck_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck_root, ignore_errors=True)
    e, args, ev, fs = small_storm_setup(dev)
    try:
        e.train_batched_checkpointed(
            *args, _Killer(CheckpointManager(str(ck_root / "train")), 1),
            eval_app=ev, faults=fs)
        fail("the killed checkpointed training did not stop")
    except _Crash:
        pass
    mgr = CheckpointManager(str(ck_root / "train"))
    if mgr.latest_step() != 1:
        fail(f"killed training left checkpoint {mgr.latest_step()}, not 1")
    r_qs, r_h = e.train_batched_checkpointed(*args, mgr, eval_app=ev,
                                             faults=fs)
    same_tree("resumed training vs uninterrupted (card)", r_qs, g_qs,
              qlearn.QState._fields)
    if not all(torch.equal(a, r) for a, r in zip(r_h, g_h)):
        fail("resumed training: histories differ from the uninterrupted "
             "run")
    same_tree("resumed training on the card vs CPU", r_qs, c_qs)

    def small_stream(device, directory, die_after=None):
        e = vec.VecEnv(s1, seed=1, device=device)
        app = vec.compile_app(apps.make_application(s1, seed=50,
                                                    n_phases=2), s1, seed=4)
        spec = vec.learned_policy_spec(qlearn.init_qstate(device=device),
                                       e._sched(app))
        tspec = traffic.bursty(4e-3, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                               priority=(1.0, 0.25), backoff=400.0,
                               overload_frac=0.35, prio_reserve=0.25, seed=3)
        mgr = CheckpointManager(str(directory))
        if die_after is not None:
            mgr = _Killer(mgr, die_after)
        return vec.ServeEnv(e, queue_cap=4, n_requests=64).serve_checkpointed(
            app, spec, tspec, mgr, n_chunks=3,
            cfg=qlearn.QConfig(decay_steps=200), key=prng.PRNGKey(8),
            faults=faults.storm(64, 0.7, prng.PRNGKey(42), device=device))

    whole = small_stream(dev, ck_root / "whole")
    try:
        small_stream(dev, ck_root / "serve", die_after=1)
        fail("the killed checkpointed serving did not stop")
    except _Crash:
        pass
    resumed = small_stream(dev, ck_root / "serve")
    on_cpu = small_stream("cpu", ck_root / "cpu")
    for cls, a, r, c in zip((soc_ref.ServeCarry, qlearn.QState,
                             vec.ServeResult), resumed, whole, on_cpu):
        same_tree("resumed serving vs uninterrupted (card)", a, r,
                  cls._fields)
        same_tree("resumed serving on the card vs CPU", a, c,
                  ("retries", "depth"))
    shutil.rmtree(ck_root, ignore_errors=True)
    print("checkpointed storm training (killed after 1 of 2 iterations) and "
          "serving (killed after 1 of 3 chunks), resumed on the card: "
          "bitwise equal to uninterrupted runs, == CPU plain path")

    # ---- 4. Fig. 6 at full width ------------------------------------------
    counts = {}
    read = lambda: (soc_ops.launches, soc_ops.serve_launches,
                    soc_ops.fault_launches, soc_ops.fault_serve_launches,
                    soc_ops.mlp_launches, soc_ops.mlp_fault_launches,
                    fa_ops.launches, rw_ops.launches, gmm_ops.launches,
                    rg_ops.launches)

    def reset_counts():
        soc_ops.reset_launches()
        fa_ops.reset_launches()
        rw_ops.reset_launches()
        gmm_ops.reset_launches()
        rg_ops.reset_launches()

    fa_bodies = {}

    def check_bodies(path, prefill, decode):
        """Every (bf16) K3 launch of an LM path went through the tensor-core
        prefill or the split decode, as many of each as its layers say."""
        got = dict(fa_ops.body_launches)
        want = {"tc_prefill": prefill, "split_decode": decode,
                "fp32_prefill": 0}
        if got != want:
            fail(f"{path}: K3 bodies {got}, expected {want}")
        fa_bodies[path] = got
        print(f"{path}: K3 launches by body {got}")

    test_app = apps.make_application(soc, seed=TEST_SEED, n_phases=N_PHASES)
    torch.cuda.synchronize()
    reset_counts()
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
    counts["fig6"] = read()
    expected = ITERS + 2 + 1   # train iterations, baseline + eval, suite
    if counts["fig6"] != (expected, 0, 0, 0, 0, 0, 0, 0, 0, 0):
        fail(f"Fig. 6 launched {dict(zip(KERNELS, counts['fig6']))}, "
             f"expected {expected} of {KERNELS[0]} only")
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
          f"suite {t_end - t_eval:.3f} s), launches "
          f"{dict(zip(KERNELS, counts['fig6']))}")

    # ---- 5. Fig. 9 at full width ------------------------------------------
    torch.cuda.synchronize()
    reset_counts()
    t9 = time.perf_counter()
    r9 = fig9.run_port(dev)
    torch.cuda.synchronize()
    fig9_s = time.perf_counter() - t9
    counts["fig9"] = read()
    e9 = r9["_engine"]
    if counts["fig9"] != (e9["expected_launches"], 0, 0, 0, 0, 0, 0, 0,
                          0, 0):
        fail(f"Fig. 9 launched {dict(zip(KERNELS, counts['fig9']))}, "
             f"expected {e9['expected_launches']} of {KERNELS[0]} only")
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
          f"{e9['evaluate_s']:.3f} s), launches "
          f"{dict(zip(KERNELS, counts['fig9']))}, {e9['lanes']} lanes "
          f"padded to "
          f"{e9['padded_steps']} steps")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "fig9_port.json").write_text(
        json.dumps(r9, indent=1))

    # ---- 6. Fig. 11 at full width -----------------------------------------
    torch.cuda.synchronize()
    reset_counts()
    t11 = time.perf_counter()
    r11 = fig11.run_port(dev)
    torch.cuda.synchronize()
    fig11_s = time.perf_counter() - t11
    counts["fig11"] = read()
    e11 = r11["_engine"]
    want11 = (e11["expected_episode_launches"],
              e11["expected_serve_launches"], 0, 0, 0, 0, 0, 0, 0, 0)
    if counts["fig11"] != want11:
        fail(f"Fig. 11 launched {dict(zip(KERNELS, counts['fig11']))}, "
             f"expected {dict(zip(KERNELS, want11))}")
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
          f"sweep {e11['sweep_s']:.3f} s), launches "
          f"{dict(zip(KERNELS, counts['fig11']))}")
    (ROOT / "chiprun_out" / "fig11_port.json").write_text(
        json.dumps(r11, indent=1))

    # ---- 7. soc_step_serve vs plain at the Fig. 11 shapes, healthy (K2)
    # and under storm(1024, 0.7, PRNGKey(42)) (K2f) ------------------------
    specs1 = vec.stack_specs([
        vec.fixed_policy_spec(env1.params, sched1, 0),
        vec.fixed_policy_spec(env1.params, sched1, 3),
        vec.manual_policy_spec(env1.params, sched1),
        vec.learned_policy_spec(qlearn.init_qstate(device=dev), sched1)])
    cfg1 = qlearn.QConfig(decay_steps=4000)
    svc, n_req = cap["effective_service_cycles"], fig11.N_REQUESTS
    storm11 = faults.storm(n_req, 0.7, prng.PRNGKey(42), device=dev)

    def serve_vs_plain(mult, fs):
        """The serve kernel (faulted when ``fs`` is given) against
        ``ref.serve_episode_ref`` at ``mult`` x Fig. 11's capacity; returns
        ``(max abs err, plain ms, packed kernel arguments)``."""
        tspec = fig11._traffic(traffic, mult * cap["capacity_per_mcycle"]
                               * 1e-6, fig11.QUEUE_CAP * svc, 0.25 * svc,
                               device=dev)
        arr = traffic.sample_arrivals(tspec, n_req,
                                      sched1.acc_id.shape[0])
        xs = vec.serve_inputs(env1.params, sched1, specs1, arr,
                              prng.PRNGKey(np.arange(4), device=dev), fs)
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
        kw = dict(n_tiles=s1.n_mem_tiles, n_actions=4, faulted=xs.faulted)
        kc, ky = soc_kernel.soc_step_serve(xf, xi, xv, consts, carry0, **kw)
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        rc, ry = soc_ref.serve_episode_ref(
            env1.static, specs1.learned, rewards.PAPER_DEFAULT_WEIGHTS, sp,
            carry0, xs, *rows)
        ev1.record()
        torch.cuda.synchronize()
        name = "soc_step_serve_faulted" if fs is not None else \
            "soc_step_serve"
        what = f"{name} vs plain ({mult:g}x load)"
        err = compare_cols(torch, what, soc_ref.SERVE_YCOLS, ky, ry,
                           SERVE_INT_COLS)
        for f in soc_ref.ServeCarry._fields:
            a, r = getattr(kc, f), getattr(rc, f)
            if not torch.allclose(a.float(), r.float(), rtol=TOL, atol=TOL):
                fail(f"{what}: carry {f} differs")
            err = max(err, (a.float() - r.float()).abs().max().item())
        ex = ry[..., soc_ref.SERVE_YCOLS.index("executed")]
        deg = ry[..., soc_ref.SERVE_YCOLS.index("degraded")]
        print(f"{what} B=4 S={n_req}: integer columns equal, max abs err "
              f"{err:.3e} (bound {TOL}); served {int(ex.sum())}/"
              f"{ex.numel()}, degraded steps {int(deg.sum())}")
        if mult > 1.0 and not (float(ex.mean()) < 1.0
                               and float(deg.max()) == 1.0):
            fail(f"{what}: the overload neither shed nor tripped the "
                 "watchdog")
        if fs is not None:
            # one chunk split in two chains through the carry, bitwise
            h = n_req // 2
            c1, y1 = soc_kernel.soc_step_serve(
                xf[:, :h].contiguous(), xi[:, :h].contiguous(),
                xv[:, :h].contiguous(), consts, carry0, **kw)
            c2, y2 = soc_kernel.soc_step_serve(
                xf[:, h:].contiguous(), xi[:, h:].contiguous(),
                xv[:, h:].contiguous(), consts, c1, **kw)
            if not (torch.equal(torch.cat([y1, y2], 1), ky)
                    and all(torch.equal(a, r) for a, r in zip(c2, kc))):
                fail(f"{what}: two chained half chunks differ from one")
            print(f"{what}: two chained chunks of {h} requests == one of "
                  f"{n_req}, bitwise")
        return err, ev0.elapsed_time(ev1), ((xf, xi, xv, consts, carry0),
                                            kw)

    sv_err, _, _ = serve_vs_plain(0.2, None)
    err, sv_plain_ms, sv_packed = serve_vs_plain(2.0, None)
    sv_err = max(sv_err, err)
    svf_err, _, _ = serve_vs_plain(0.2, storm11)
    err, svf_plain_ms, svf_packed = serve_vs_plain(2.0, storm11)
    svf_err = max(svf_err, err)

    # ---- 8. Fig. 10 at full width -----------------------------------------
    torch.cuda.synchronize()
    reset_counts()
    t10 = time.perf_counter()
    r10 = fig10.run_port(dev)
    torch.cuda.synchronize()
    fig10_s = time.perf_counter() - t10
    counts["fig10"] = read()
    e10 = r10["_engine"]
    want10 = (e10["expected_episode_launches"], 0,
              e10["expected_fault_episode_launches"], 0, 0, 0, 0, 0, 0,
              0)
    if counts["fig10"] != want10 or 0 in want10[0:3:2]:
        fail(f"Fig. 10 launched {dict(zip(KERNELS, counts['fig10']))}, "
             f"expected {dict(zip(KERNELS, want10))}")
    for label, _ in fig10.INTENSITIES:
        row = r10[label]
        vals = ([v for fam in fig10.FAMILIES for v in row[fam]]
                + [row[k] for k in fig10.SCALARS])
        if not all(math.isfinite(v) for v in vals):
            fail(f"Fig. 10 {label}: non-finite metrics")
        print(f"fig10 {label}: " + " ".join(
            f"{fam}=({row[fam][0]:.6f}, {row[fam][1]:.6f})"
            for fam in fig10.FAMILIES)
            + f" q_delta={row['q_delta_vs_fixed']:.6f} "
            f"storm_slowdown={row['storm_slowdown']:.6f}")
    if not r10["severe"]["storm_slowdown"] > 1.0:
        fail("Fig. 10: the severe storm did not slow the NON_COH baseline")
    print(f"fig10 path on {card}: {fig10_s:.3f} s wall ("
          + ", ".join(f"{k} {v:.3f} s"
                      for k, v in e10["intensity_s"].items())
          + f"), launches {dict(zip(KERNELS, counts['fig10']))}; DES "
          f"cross-check: {r10['_des_crosscheck']['status']}")
    (ROOT / "chiprun_out" / "fig10_port.json").write_text(
        json.dumps(r10, indent=1))

    # ---- 9. storm serving through ServeEnv at full width -------------------
    torch.cuda.synchronize()
    reset_counts()
    t_st = time.perf_counter()
    _, st_qs, st_res = vec.ServeEnv(
        env1, queue_cap=fig11.QUEUE_CAP, n_requests=n_req).serve_specs(
        app1, specs1, fig11._traffic(
            traffic, cap["capacity_per_mcycle"] * 1e-6,
            fig11.QUEUE_CAP * svc, 0.25 * svc), cfg=cfg1, faults=storm11)
    torch.cuda.synchronize()
    storm_s = time.perf_counter() - t_st
    counts["storm_serving"] = read()
    if counts["storm_serving"] != (0, 0, 0, 1, 0, 0, 0, 0, 0, 0):
        fail(f"storm serving launched "
             f"{dict(zip(KERNELS, counts['storm_serving']))}, expected one "
             f"{KERNELS[3]}")
    ex = st_res.executed
    if not (bool(torch.isfinite(st_res.latency).all())
            and bool(torch.isfinite(st_qs.qtable).all())
            and int(ex.sum()) > 0):
        fail("storm serving: non-finite or empty results")
    for i, name in enumerate(fig11.POLICIES):
        lat = st_res.latency[i][ex[i]].double()
        print(f"storm serving {name}: served {int(ex[i].sum())}/{n_req}, "
              f"p99 latency {float(torch.quantile(lat, 0.99)):.6g} cycles, "
              f"mean exec {float(st_res.exec_time[i][ex[i]].mean()):.6g}")
    print(f"storm serving path on {card}: {storm_s:.3f} s wall, launches "
          f"{dict(zip(KERNELS, counts['storm_serving']))}")

    # ---- 9b. Fig. 13 at full width -----------------------------------------
    torch.cuda.synchronize()
    reset_counts()
    t13 = time.perf_counter()
    r13, agents13 = fig13.run_port(dev, keep_agents=True)
    torch.cuda.synchronize()
    fig13_s = time.perf_counter() - t13
    counts["fig13"] = read()
    e13 = r13["_engine"]
    want13 = (e13["expected_episode_launches"], 0, 0, 0,
              e13["expected_mlp_episode_launches"], 0, 0, 0, 0, 0)
    if counts["fig13"] != want13 or 0 in want13[0:5:4]:
        fail(f"Fig. 13 launched {dict(zip(KERNELS, counts['fig13']))}, "
             f"expected {dict(zip(KERNELS, want13))}")
    vals = r13["train_reward_history"] + [
        v for st in fig13.SETS for row in r13["per_soc"][st]
        for a in fig13.AGENTS for v in row[a]]
    if not all(math.isfinite(v) for v in vals):
        fail("Fig. 13: non-finite metrics")
    if not bool(torch.isfinite(agents13[1].wpack).all()):
        fail("Fig. 13: non-finite trained network")
    fig13.print_results("fig13", r13)
    print(f"fig13 path on {card}: {fig13_s:.3f} s wall (train MLP "
          f"{e13['train_mlp_s']:.3f} s, train table "
          f"{e13['train_table_s']:.3f} s, evaluate {e13['eval_s']:.3f} s), "
          f"launches {dict(zip(KERNELS, counts['fig13']))}")
    (ROOT / "chiprun_out" / "fig13_port.json").write_text(
        json.dumps(r13, indent=1))

    # ---- 9c. flash_attention (K3) vs plain: the serving path's prefill
    # and decode shapes, tests/test_kernels.py's feature cases in both
    # types, and a Gemma-2-shaped case ------------------------------------
    fa_gen = torch.Generator(device=dev).manual_seed(0)
    fa_errs = {}

    def qkv(b, h, hkv, sq, skv, hd, dt, s_max=None):
        mk = lambda *shape: torch.randn(*shape, generator=fa_gen,
                                        device=dev).to(dt)
        return (mk(b, sq, h, hd), mk(b, s_max or skv, hkv, hd),
                mk(b, s_max or skv, hkv, hd))

    def fa_vs_plain(what, q, k, v, body=None, **feat):
        """K3 against ``ref.attention_ref`` on the same inputs (rtol = atol
        = 2e-5 in float32, 2e-2 in bfloat16, the reference's own), through
        ``body`` where one is named, and bitwise equal to a second launch;
        returns the max abs error."""
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
        got, plan = fa_kernel.launch(q, k, v, **feat)
        again = fa_kernel.flash_attention(q, k, v, **feat)
        torch.cuda.synchronize()
        if body is not None and plan.body != body:
            fail(f"flash_attention {what} took {plan.body}, not {body}")
        if not torch.equal(got, again):
            fail(f"flash_attention {what}: two launches differ")
        want = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), **feat).transpose(1, 2)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != q.dtype or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention vs plain {what}: max abs err {err}")
        key = f"{plan.body} {str(q.dtype).split('.')[-1]}"
        fa_errs[key] = max(fa_errs.get(key, 0.0), err)
        print(f"flash_attention vs plain {what} ({plan.body}"
              f"{f', {plan.splits} splits' if plan.splits > 1 else ''}): "
              f"max abs err {err:.3e} (bound {tol}); a second launch "
              f"bitwise equal")
        return err

    def fa_probe(what, shape, body="tc_prefill", s_max=None, **feat):
        """A bf16 body's coverage probe (``ref.probe_*``): with q = 0 and
        a one-hot v, every output is exactly 0 where its probe key is
        hidden and within 1% of 1 / n_visible where it is seen, for probe
        keys swept over every key; with ``s_max``, k and v are the first
        Skv rows of an ``s_max``-row cache whose later rows hold v = 1, so
        a key read past Skv shows too.  Returns the passes."""
        b, h, hkv, sq, skv, hd = shape
        passes = -(-skv // (b * hkv * hd))
        for sweep in range(passes):
            keys = fa_ref.probe_keys(b, hkv, hd, skv, sweep, device=dev)
            q, k, v = fa_ref.probe_inputs(b, h, hkv, sq, skv, hd, keys,
                                          torch.bfloat16, dev, seed=sweep)
            if s_max:
                kc = torch.randn((b, s_max, hkv, hd), generator=fa_gen,
                                 device=dev).to(torch.bfloat16)
                vc = torch.ones_like(kc)
                kc[:, :skv], vc[:, :skv] = k, v
                k, v = kc[:, :skv], vc[:, :skv]
            out, plan = fa_kernel.launch(q, k, v, **feat)
            bad = fa_ref.probe_faults(out, fa_ref.probe_expected(
                keys, sq, skv, h, **feat))
            if plan.body != body or bad:
                fail(f"flash_attention coverage probe {what} pass {sweep}: "
                     f"{bad} wrong outputs ({plan.body}, not {body})")
            del q, k, v, out
        print(f"flash_attention coverage probe {what} {shape} {feat} "
              f"({body}{f', {plan.splits} splits' if plan.splits > 1 else ''}"
              f"): {passes} passes over all {skv} keys, exact")
        return passes

    def fa_decode_probes(what, shape, s_max=None, sqs=(1, 4, 7), **feat):
        """The split decode at ``shape`` with 1, 4 and 7 query rows (the
        rows that fit one split block): the coverage probe over every key
        (split and tile edges, the last split's lone key), and random
        inputs with q four times larger, so each query head's softmax
        peaks on its own few keys and a row given another head's or
        another query row's output misses by ~1, not by bf16's ulps."""
        b, h, hkv, _, skv, hd = shape
        for sq in sqs:
            rows = (b, h, hkv, sq, skv, hd)
            fa_probe(f"{what} Sq {sq}", rows, body="split_decode",
                     s_max=s_max, **feat)
            q, kc, vc = qkv(*rows, torch.bfloat16, s_max=s_max)
            fa_vs_plain(f"{what} {rows} bf16, q x 4", (4 * q.float()).to(
                torch.bfloat16), kc[:, :skv], vc[:, :skv],
                body="split_decode", **feat)

    qp, kp, vp = qkv(*FA_PREFILL, torch.bfloat16)
    fa_err = fa_vs_plain(f"prefill {FA_PREFILL} bf16 causal", qp, kp, vp,
                         body="tc_prefill")
    qd, kc, vc = qkv(*FA_DECODE[:6], torch.bfloat16, s_max=FA_DECODE[6])
    kd, vd = kc[:, :FA_DECODE[4]], vc[:, :FA_DECODE[4]]   # cache slices
    fa_err = max(fa_err, fa_vs_plain(
        f"decode {FA_DECODE[:6]} bf16 over a cache of {FA_DECODE[6]}",
        qd, kd, vd, body="split_decode"))
    fa_probe("Qwen3 prefill", FA_PREFILL, causal=True)
    fa_decode_probes("Qwen3 decode", FA_DECODE[:6], FA_DECODE[6],
                     causal=True)
    # granite-moe-3b-a800m's shapes (head dim 64, 24 heads over 8)
    gr_fa = {"prefill": qkv(*FA_GR_PREFILL, torch.bfloat16)}
    qg, kgc, vgc = qkv(*FA_GR_DECODE[:6], torch.bfloat16,
                       s_max=FA_GR_DECODE[6])
    gr_fa["decode"] = (qg, kgc[:, :FA_GR_DECODE[4]], vgc[:, :FA_GR_DECODE[4]])
    fa_err = max(fa_err, fa_vs_plain(
        f"granite prefill {FA_GR_PREFILL} bf16 causal", *gr_fa["prefill"],
        body="tc_prefill"))
    fa_err = max(fa_err, fa_vs_plain(
        f"granite decode {FA_GR_DECODE[:6]} bf16 over a cache of "
        f"{FA_GR_DECODE[6]}", *gr_fa["decode"], body="split_decode"))
    fa_probe("granite prefill", FA_GR_PREFILL, causal=True)
    fa_decode_probes("granite decode", FA_GR_DECODE[:6], FA_GR_DECODE[6],
                     causal=True)
    fa_vs_plain(f"granite decode {FA_GR_DECODE[:6]} float32",
                *qkv(*FA_GR_DECODE[:6], torch.float32), body="split_decode")
    # the same two shapes in float32: the outputs' spread is ~0.04 at
    # Skv 2049, so bf16's 2e-2 would pass a kernel that dropped the
    # newest key (~1e-3) or a whole tile; 2e-5 would not
    fa_vs_plain(f"prefill {FA_PREFILL} float32 causal",
                *qkv(*FA_PREFILL, torch.float32), body="fp32_prefill")
    q32, kc32, vc32 = qkv(*FA_DECODE[:6], torch.float32, s_max=FA_DECODE[6])
    fa_vs_plain(f"decode {FA_DECODE[:6]} float32 over a cache of "
                f"{FA_DECODE[6]}", q32, kc32[:, :FA_DECODE[4]],
                vc32[:, :FA_DECODE[4]], body="split_decode")
    del q32, kc32, vc32
    for dt in (torch.float32, torch.bfloat16):
        for shape in FA_SHAPES:
            for feat in FA_FEATS:
                fa_vs_plain(f"{shape} {dt} {feat}", *qkv(*shape, dt), **feat)
    fa_vs_plain("Gemma-2 (1, 16, 8, 4608, 4608, 256) bf16, window 4096, "
                "soft-cap 50", *qkv(1, 16, 8, 4608, 4608, 256,
                                    torch.bfloat16),
                body="tc_prefill", window=4096, softcap=50.0)
    # the window's edge: keys 4,096 behind a row drop out of it
    fa_probe("Gemma-2 local prefill", (1, 16, 8, 4608, 4608, 256),
             causal=True, window=4096)
    fa_decode_probes("Gemma-2 local decode", (1, 16, 8, 1, 4608, 256),
                     causal=True, window=4096)

    # ---- 9d. the Qwen3 smoke serve: card == CPU plain path (float32) ------
    scfg = smoke_config("qwen3-8b")
    smoke_params = lambda: lm.init_params(
        scfg, torch.Generator().manual_seed(0), "cpu")
    s_cpu = lm_serve.serve(scfg, 2, 16, 8, device="cpu",
                           params=smoke_params())
    s_card = lm_serve.serve(scfg, 2, 16, 8, device=dev,
                            params=smoke_params().to(dev))
    if not np.array_equal(s_card["generated"], s_cpu["generated"]):
        fail("Qwen3 smoke serve: card and CPU generated different tokens")
    lm_err = max((s_card[k].cpu() - s_cpu[k]).abs().max().item()
                 for k in ("prefill_logits", "logits"))
    if lm_err > LM_TOL:
        fail(f"Qwen3 smoke serve: card logits {lm_err} from the CPU's")
    print(f"Qwen3 smoke serve (B=2, prompt 16, gen 8, float32): tokens "
          f"equal on the card and the CPU, logits within {lm_err:.3e} "
          f"(bound {LM_TOL})")

    # ---- 9e. Qwen3-8B serving at full width --------------------------------
    qcfg = get_arch("qwen3-8b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t_q = time.perf_counter()
    q_out = lm_serve.serve(qcfg, batch=QWEN_BATCH, prompt_len=QWEN_PROMPT,
                           gen=QWEN_GEN, seed=0, device=dev)
    torch.cuda.synchronize()
    qwen_s = time.perf_counter() - t_q
    counts["qwen3_serve"] = read()
    check_bodies("qwen3_serve", qcfg.n_layers, qcfg.n_layers * QWEN_GEN)
    want_q = (0, 0, 0, 0, 0, 0, qcfg.n_layers * (1 + QWEN_GEN), 0, 0, 0)
    if counts["qwen3_serve"] != want_q:
        fail(f"Qwen3-8B serve launched "
             f"{dict(zip(KERNELS, counts['qwen3_serve']))}, expected "
             f"{dict(zip(KERNELS, want_q))}")
    if not (bool(torch.isfinite(q_out["prefill_logits"]).all())
            and bool(torch.isfinite(q_out["logits"]).all())):
        fail("Qwen3-8B serve: non-finite logits")
    if q_out["generated"].shape != (QWEN_BATCH, QWEN_GEN):
        fail(f"Qwen3-8B serve: generated {q_out['generated'].shape}")
    q_mem = torch.cuda.max_memory_allocated()
    print(f"qwen3-8b serve (B={QWEN_BATCH}, prompt {QWEN_PROMPT}, gen "
          f"{QWEN_GEN}, bf16 compute, float32 parameters) on {card}: "
          f"prefill {q_out['prefill_s']:.4f} s, decode "
          f"{q_out['decode_s']:.4f} s ({q_out['decode_s'] / QWEN_GEN * 1e3:.2f}"
          f" ms/step, {q_out['decode_tok_per_s']:.1f} tok/s), bf16 weight "
          f"copy {q_out['cast_s']:.4f} s, {qwen_s:.3f} s wall with the "
          f"weights' init; peak memory {q_mem / 2**30:.2f} GiB; launches "
          f"{dict(zip(KERNELS, counts['qwen3_serve']))}; first tokens "
          f"{q_out['generated'][0, :8].tolist()}")
    del q_out
    torch.cuda.empty_cache()

    # ---- 9f. rwkv6_scan (K5) vs plain: the rwkv6-3b prefill's shape from a
    # zero and a random state, tests/test_kernels.py's shapes and its
    # two-halves state composition, in float32 at 2e-5 ------------------
    rw_gen = torch.Generator(device=dev).manual_seed(0)

    def scan_inputs(b, h, t, k, state=False):
        """r, k, v, logw (clamped at -4, as tests/test_kernels.py draws
        it), u and a zero or random initial state, on the card."""
        mk = lambda *shape: torch.randn(*shape, generator=rw_gen, device=dev)
        lw = torch.clamp(-torch.exp(0.5 * mk(b, h, t, k)), min=-4.0)
        s0 = mk(b, h, k, k) if state else torch.zeros((b, h, k, k),
                                                       device=dev)
        return mk(b, h, t, k), mk(b, h, t, k), mk(b, h, t, k), lw, \
            mk(h, k), s0

    def scan_vs_plain(what, got, want):
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not all(torch.allclose(g, w, rtol=TOL, atol=TOL)
                   for g, w in zip(got, want)):
            fail(f"rwkv6_scan vs plain {what}: max abs err {err}")
        print(f"rwkv6_scan vs plain {what}: max abs err {err:.3e} (bound "
              f"{TOL})")
        return err

    def scan_check(what, *args):
        got = rw_kernel.rwkv6_scan(*args)
        torch.cuda.synchronize()
        return scan_vs_plain(what, got, rw_ref.wkv_ref(*args))

    rw_in = scan_inputs(*RWKV_SCAN)
    rw_err = scan_check(f"{RWKV_SCAN} from a zero state", *rw_in)
    rw_err = max(rw_err, scan_check(f"{RWKV_SCAN} from a random state",
                                    *scan_inputs(*RWKV_SCAN, state=True)))
    for shape in RWKV_SHAPES:
        scan_check(f"{shape}", *scan_inputs(*shape))
        scan_check(f"{shape} from a random state",
                   *scan_inputs(*shape, state=True))
    *rkvw, rw_u, _ = scan_inputs(*RWKV_COMPOSE)
    half = RWKV_COMPOSE[2] // 2
    whole = rw_kernel.rwkv6_scan(*rkvw, rw_u)
    _, s_half = rw_kernel.rwkv6_scan(*(x[:, :, :half] for x in rkvw), rw_u)
    second = rw_kernel.rwkv6_scan(*(x[:, :, half:] for x in rkvw), rw_u,
                                  s_half)
    torch.cuda.synchronize()
    scan_vs_plain(f"{RWKV_COMPOSE}: two halves with the state carried vs "
                  "the whole", second, (whole[0][:, :, half:], whole[1]))
    del rkvw, whole, second

    # ---- 9g. the rwkv6 smoke serve: card == CPU plain path (float32) ------
    rcfg_s = smoke_config("rwkv6-3b")

    def rwkv_smoke_params():
        """Random smoke weights with the reference's zero-initialised
        ``u``, LoRA-b matrices and ``ln_w`` set from a seed, so the bonus,
        the LoRA mixing and the decay are compared too."""
        p = lm.init_params(rcfg_s, torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        for layer in p.layers:
            for name in ("u", "mix_lora_b", "w_lora_b", "ln_w"):
                w = getattr(layer.tm, name)
                w.copy_(0.5 * torch.randn(w.shape, generator=g))
        return p

    r_cpu = lm_serve.serve(rcfg_s, 2, 32, 8, device="cpu",
                           params=rwkv_smoke_params())
    r_card = lm_serve.serve(rcfg_s, 2, 32, 8, device=dev,
                            params=rwkv_smoke_params().to(dev))
    if not np.array_equal(r_card["generated"], r_cpu["generated"]):
        fail("rwkv6 smoke serve: card and CPU generated different tokens")
    rw_lm_err = max((r_card[k].cpu() - r_cpu[k]).abs().max().item()
                    for k in ("prefill_logits", "logits"))
    if rw_lm_err > LM_TOL:
        fail(f"rwkv6 smoke serve: card logits {rw_lm_err} from the CPU's")
    print(f"rwkv6 smoke serve (B=2, prompt 32, gen 8, float32): tokens "
          f"equal on the card and the CPU, logits within {rw_lm_err:.3e} "
          f"(bound {LM_TOL})")

    # ---- 9h. rwkv6-3b serving at full width --------------------------------
    rcfg = get_arch("rwkv6-3b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t_r = time.perf_counter()
    r_out = lm_serve.serve(rcfg, batch=QWEN_BATCH, prompt_len=QWEN_PROMPT,
                           gen=QWEN_GEN, seed=0, device=dev)
    torch.cuda.synchronize()
    rwkv_s = time.perf_counter() - t_r
    counts["rwkv6_serve"] = read()
    want_r = (0, 0, 0, 0, 0, 0, 0, rcfg.n_layers, 0, 0)
    if counts["rwkv6_serve"] != want_r:
        fail(f"rwkv6-3b serve launched "
             f"{dict(zip(KERNELS, counts['rwkv6_serve']))}, expected "
             f"{dict(zip(KERNELS, want_r))}")
    if not (bool(torch.isfinite(r_out["prefill_logits"]).all())
            and bool(torch.isfinite(r_out["logits"]).all())):
        fail("rwkv6-3b serve: non-finite logits")
    if r_out["generated"].shape != (QWEN_BATCH, QWEN_GEN):
        fail(f"rwkv6-3b serve: generated {r_out['generated'].shape}")
    r_mem = torch.cuda.max_memory_allocated()
    print(f"rwkv6-3b serve (B={QWEN_BATCH}, prompt {QWEN_PROMPT}, gen "
          f"{QWEN_GEN}, bf16 compute, float32 parameters and RWKV "
          f"products) on {card}: prefill {r_out['prefill_s']:.4f} s, "
          f"decode {r_out['decode_s']:.4f} s "
          f"({r_out['decode_s'] / QWEN_GEN * 1e3:.2f} ms/step, "
          f"{r_out['decode_tok_per_s']:.1f} tok/s), weight copy "
          f"{r_out['cast_s']:.4f} s, {rwkv_s:.3f} s wall with the weights' "
          f"init; peak memory {r_mem / 2**30:.2f} GiB; launches "
          f"{dict(zip(KERNELS, counts['rwkv6_serve']))}; first tokens "
          f"{r_out['generated'][0, :8].tolist()}")
    del r_out
    torch.cuda.empty_cache()

    # ---- 9i. moe_gmm (K4) vs plain: the granite serving path's prefill
    # (gate/up and down) and decode shapes, tests/test_kernels.py's shapes,
    # in float32 at 2e-5 and bf16 at the reference's tolerance -------------
    gmm_gen = torch.Generator(device=dev).manual_seed(0)

    def gmm_inputs(lead, e, c, d, f, dt, hi, real=None):
        """x (*lead, E, C, D), w (E, D, F) (at the model's init scale
        where ``real`` is given) and seeded group sizes in [0, hi], the
        padded experts' (from ``real`` on) at 0."""
        mk = lambda *shape: torch.randn(*shape, generator=gmm_gen,
                                        device=dev)
        w = mk(e, d, f) / (d ** 0.5 if real else 1.0)
        sizes = torch.randint(0, hi + 1, (*lead, e), generator=gmm_gen,
                              device=dev, dtype=torch.int32)
        if real:
            sizes[..., real:] = 0
        return mk(*lead, e, c, d).to(dt), w.to(dt), sizes

    def gmm_check(what, x, w, sizes):
        """K4 against ``ref.gmm_ref`` on the same inputs, rows past each
        group's size exactly 0; returns the max abs error."""
        tol = (GMM_BF16_TOL if x.dtype == torch.bfloat16
               else dict(rtol=TOL, atol=TOL))
        got = gmm_kernel.moe_gmm(x, w, sizes)
        torch.cuda.synchronize()
        want = gmm_ref.gmm_ref(x, w, sizes)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != x.dtype or not torch.allclose(
                got.float(), want.float(), **tol):
            fail(f"moe_gmm vs plain {what}: max abs err {err}")
        past = torch.arange(x.shape[-2], device=dev) >= sizes[..., None]
        if not bool((got[past] == 0).all()):
            fail(f"moe_gmm {what}: a row past its group's size is not 0")
        print(f"moe_gmm vs plain {what}: max abs err {err:.3e} (rtol "
              f"{tol['rtol']}, atol {tol['atol']}), rows past each size 0")
        return err

    gmm_errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for what, (b_, e, c, d, f), hi in (
                ("prefill gate/up", GMM_PREFILL, GMM_PREFILL[2]),
                ("prefill down", GMM_DOWN, GMM_DOWN[2]),
                ("decode gate/up", GMM_DECODE, 1),
                ("decode down", GMM_DECODE[:3] + GMM_DECODE[3:][::-1], 1)):
            err = gmm_check(f"{what} {(b_, e, c, d, f)} {dt}",
                            *gmm_inputs((b_,), e, c, d, f, dt, hi, GMM_REAL))
            gmm_errs[dt] = max(gmm_errs.get(dt, 0.0), err)
        for shape in GMM_SHAPES:
            gmm_check(f"{shape} {dt}", *gmm_inputs((), *shape, dt, shape[1]))

    # the MoE layers' routing on a path, read back after it (the router
    # passes through unchanged)
    routes = []
    route_fn = lm_mlp.route

    def observed_route(*args, **kwargs):
        routes.append(route_fn(*args, **kwargs))
        return routes[-1]

    def min_margin(rs, k):
        """The smallest gap between the k-th and the (k+1)-th router
        probability over the tokens of ``rs``."""
        gaps = []
        for r in rs:
            top = torch.topk(r.probs, k + 1, dim=-1).values
            gaps.append((top[..., k - 1] - top[..., k]).min().item())
        return min(gaps)

    # ---- 9j. the granite smoke serve: card == CPU plain path (float32) ----
    gcfg_s = smoke_config("granite-moe-3b-a800m")
    granite_smoke_params = lambda: lm.init_params(
        gcfg_s, torch.Generator().manual_seed(0), "cpu")
    g_cpu = lm_serve.serve(gcfg_s, 2, 19, 8, device="cpu",
                           params=granite_smoke_params())
    lm_mlp.route = observed_route
    try:
        g_card = lm_serve.serve(gcfg_s, 2, 19, 8, device=dev,
                                params=granite_smoke_params().to(dev))
    finally:
        lm_mlp.route = route_fn
    if not np.array_equal(g_card["generated"], g_cpu["generated"]):
        fail("granite smoke serve: card and CPU generated different tokens")
    g_lm_err = max((g_card[k].cpu() - g_cpu[k]).abs().max().item()
                   for k in ("prefill_logits", "logits"))
    if g_lm_err > LM_TOL:
        fail(f"granite smoke serve: card logits {g_lm_err} from the CPU's")
    print(f"granite smoke serve (B=2, prompt 19, gen 8, float32, "
          f"{gcfg_s.n_experts} experts padded to {gcfg_s.padded_experts}, "
          f"top-{gcfg_s.top_k}): tokens equal on the card and the CPU, "
          f"logits within {g_lm_err:.3e} (bound {LM_TOL}); smallest top-k "
          f"margin the router saw {min_margin(routes, gcfg_s.top_k):.3e}")
    routes.clear()

    # ---- 9k. granite-moe-3b-a800m serving at full width -------------------
    gcfg = get_arch("granite-moe-3b-a800m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    lm_mlp.route = observed_route
    try:
        t_g = time.perf_counter()
        g_out = lm_serve.serve(gcfg, batch=QWEN_BATCH,
                               prompt_len=QWEN_PROMPT, gen=QWEN_GEN, seed=0,
                               device=dev)
        torch.cuda.synchronize()
        granite_s = time.perf_counter() - t_g
    finally:
        lm_mlp.route = route_fn
    counts["granite_serve"] = read()
    check_bodies("granite_serve", gcfg.n_layers, gcfg.n_layers * QWEN_GEN)
    steps_g = gcfg.n_layers * (1 + QWEN_GEN)
    want_g = (0, 0, 0, 0, 0, 0, steps_g, 0, 3 * steps_g, 0)
    if counts["granite_serve"] != want_g:
        fail(f"granite-moe-3b-a800m serve launched "
             f"{dict(zip(KERNELS, counts['granite_serve']))}, expected "
             f"{dict(zip(KERNELS, want_g))}")
    if not (bool(torch.isfinite(g_out["prefill_logits"]).all())
            and bool(torch.isfinite(g_out["logits"]).all())):
        fail("granite-moe-3b-a800m serve: non-finite logits")
    if g_out["generated"].shape != (QWEN_BATCH, QWEN_GEN):
        fail(f"granite-moe-3b-a800m serve: generated "
             f"{g_out['generated'].shape}")
    g_mem = torch.cuda.max_memory_allocated()
    pre_routes = [r for r in routes if r.probs.shape[1] == QWEN_PROMPT]
    dec_routes = [r for r in routes if r.probs.shape[1] == 1]
    if (len(pre_routes), len(dec_routes)) != (gcfg.n_layers,
                                              gcfg.n_layers * QWEN_GEN):
        fail(f"granite-moe-3b-a800m serve: {len(pre_routes)} prefill and "
             f"{len(dec_routes)} decode MoE calls")
    g_drop = sum(1.0 - r.keep.float().mean().item()
                 for r in pre_routes) / len(pre_routes)
    print(f"granite-moe-3b-a800m serve (B={QWEN_BATCH}, prompt "
          f"{QWEN_PROMPT}, gen {QWEN_GEN}, bf16 compute, float32 parameters "
          f"and router) on {card}: prefill {g_out['prefill_s']:.4f} s, "
          f"decode {g_out['decode_s']:.4f} s "
          f"({g_out['decode_s'] / QWEN_GEN * 1e3:.2f} ms/step, "
          f"{g_out['decode_tok_per_s']:.1f} tok/s), bf16 weight copy "
          f"{g_out['cast_s']:.4f} s, {granite_s:.3f} s wall with the "
          f"weights' init; peak memory {g_mem / 2**30:.2f} GiB; prefill's "
          f"mean drop_frac {g_drop:.4f}, capacity {pre_routes[0].cap} rows; "
          f"smallest top-k margin {min_margin(pre_routes, gcfg.top_k):.3e}; "
          f"launches {dict(zip(KERNELS, counts['granite_serve']))}; first "
          f"tokens {g_out['generated'][0, :8].tolist()}")
    # the group sizes K4 took in the first layer's prefill and first
    # decode step, for the times below
    gmm_sizes = (pre_routes[0].sizes, dec_routes[0].sizes)
    del g_out, pre_routes, dec_routes
    routes.clear()
    torch.cuda.empty_cache()

    # ---- 9l. rglru_scan (K6) vs plain: the recurrentgemma-9b prefill's
    # shape from a zero and a random h0, tests/test_kernels.py's shapes,
    # at rtol = atol = 1e-5 -----------------------------------------------
    rg_gen = torch.Generator(device=dev).manual_seed(0)

    def rg_inputs(b, t, w):
        """log_a (as tests/test_kernels.py draws it), b and a random h0,
        on the card."""
        mk = lambda *shape: torch.randn(*shape, generator=rg_gen, device=dev)
        return -torch.exp(mk(b, t, w)), mk(b, t, w), mk(b, w)

    def rg_check(what, log_a, bb, h0=None):
        """K6 on ``b`` with ``h0`` folded into its first step, as ``ops``
        folds it, against ``ref.rglru_ref`` stepping from ``h0``; returns
        the max abs error."""
        folded = bb
        if h0 is not None:
            folded = bb.clone()
            folded[:, 0] = folded[:, 0] + torch.exp(log_a[:, 0]) * h0
        got = rg_kernel.rglru_scan(log_a, folded)
        torch.cuda.synchronize()
        start = torch.zeros_like(bb[:, 0]) if h0 is None else h0
        want = rg_ref.rglru_ref(log_a, bb, start)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not all(torch.allclose(g, w, rtol=RG_TOL, atol=RG_TOL)
                   for g, w in zip(got, want)):
            fail(f"rglru_scan vs plain {what}: max abs err {err}")
        print(f"rglru_scan vs plain {what}: max abs err {err:.3e} (bound "
              f"{RG_TOL})")
        return err

    *rg_in, rg_h0 = rg_inputs(*RG_SCAN)
    rg_err = rg_check(f"{RG_SCAN} from a zero state", *rg_in)
    rg_err = max(rg_err, rg_check(f"{RG_SCAN} from a random h0", *rg_in,
                                  rg_h0))
    for shape in RG_SHAPES:
        rg_check(f"{shape}", *rg_inputs(*shape)[:2])
        rg_check(f"{shape} from a random h0", *rg_inputs(*shape))
    rg_check("(2, 37, 100): T and W divided by no tile",
             *rg_inputs(2, 37, 100))
    del rg_h0

    # ---- 9m. flash_attention (K3) at the recurrentgemma-9b path's shapes:
    # head dim 256, 16 query heads on one kv head, the prefill's window of
    # 2,048, the decode over the whole ring; bf16 and float32 -------------
    rg_fa = {}
    for dt in (torch.bfloat16, torch.float32):
        pre = qkv(*FA_RG_PREFILL, dt)
        dec = qkv(*FA_RG_DECODE, dt)
        err = fa_vs_plain(f"recurrentgemma prefill {FA_RG_PREFILL} {dt}, "
                          f"window {RG_WINDOW}", *pre, window=RG_WINDOW,
                          body=("tc_prefill" if dt == torch.bfloat16
                                else "fp32_prefill"))
        err = max(err, fa_vs_plain(f"recurrentgemma decode {FA_RG_DECODE} "
                                   f"{dt} over the whole ring", *dec,
                                   body="split_decode"))
        if dt == torch.bfloat16:
            fa_err = max(fa_err, err)
            rg_fa = {"prefill": pre, "decode": dec}
    del pre, dec
    fa_probe("recurrentgemma prefill", FA_RG_PREFILL, causal=True,
             window=RG_WINDOW)
    # 16 query heads a kv head: 4 query rows fill the block's 64 rows
    fa_decode_probes("recurrentgemma ring decode", FA_RG_DECODE,
                     sqs=(1, 4), causal=True)

    # ---- 9n. the recurrentgemma smoke serve: card == CPU plain path
    # (float32) ------------------------------------------------------------
    gmcfg_s = smoke_config("recurrentgemma-9b")

    def rgemma_smoke_params():
        """Random smoke weights with the reference's zero-initialised
        norms, ``ba``, ``bx`` and ``conv_b`` and its constant ``lam`` set
        from a seed, so a swapped bias or a per-channel error shows."""
        p = lm.init_params(gmcfg_s, torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        normal = lambda w, sc: w.copy_(sc * torch.randn(w.shape,
                                                        generator=g))
        for layer in p.layers:
            normal(layer.ln1, 0.3)
            normal(layer.ln2, 0.3)
            if hasattr(layer, "rg"):
                for name, sc in (("ba", 0.5), ("bx", 0.5), ("conv_b", 0.5),
                                 ("lam", 1.0)):
                    normal(getattr(layer.rg, name), sc)
        return p

    c_cpu = lm_serve.serve(gmcfg_s, 2, 19, 8, device="cpu",
                           params=rgemma_smoke_params())
    c_card = lm_serve.serve(gmcfg_s, 2, 19, 8, device=dev,
                            params=rgemma_smoke_params().to(dev))
    if not np.array_equal(c_card["generated"], c_cpu["generated"]):
        fail("recurrentgemma smoke serve: card and CPU generated different "
             "tokens")
    rg_lm_err = max((c_card[k].cpu() - c_cpu[k]).abs().max().item()
                    for k in ("prefill_logits", "logits"))
    if rg_lm_err > LM_TOL:
        fail(f"recurrentgemma smoke serve: card logits {rg_lm_err} from "
             "the CPU's")
    print(f"recurrentgemma smoke serve (B=2, prompt 19, gen 8, float32, "
          f"window {gmcfg_s.sliding_window}: the prompt and the decode wrap "
          f"the ring): tokens equal on the card and the CPU, logits within "
          f"{rg_lm_err:.3e} (bound {LM_TOL})")

    # ---- 9o. recurrentgemma-9b serving at full width -----------------------
    gmcfg = get_arch("recurrentgemma-9b")
    kinds = lm.layer_kinds(gmcfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t_rg = time.perf_counter()
    c_out = lm_serve.serve(gmcfg, batch=QWEN_BATCH, prompt_len=QWEN_PROMPT,
                           gen=QWEN_GEN, seed=0, device=dev)
    torch.cuda.synchronize()
    rgemma_s = time.perf_counter() - t_rg
    counts["recurrentgemma_serve"] = read()
    check_bodies("recurrentgemma_serve", kinds.count("attn_local"),
                 kinds.count("attn_local") * QWEN_GEN)
    want_c = (0, 0, 0, 0, 0, 0, kinds.count("attn_local") * (1 + QWEN_GEN),
              0, 0, kinds.count("rg"))
    if counts["recurrentgemma_serve"] != want_c:
        fail(f"recurrentgemma-9b serve launched "
             f"{dict(zip(KERNELS, counts['recurrentgemma_serve']))}, "
             f"expected {dict(zip(KERNELS, want_c))}")
    if not (bool(torch.isfinite(c_out["prefill_logits"]).all())
            and bool(torch.isfinite(c_out["logits"]).all())):
        fail("recurrentgemma-9b serve: non-finite logits")
    if c_out["generated"].shape != (QWEN_BATCH, QWEN_GEN):
        fail(f"recurrentgemma-9b serve: generated "
             f"{c_out['generated'].shape}")
    c_mem = torch.cuda.max_memory_allocated()
    print(f"recurrentgemma-9b serve (B={QWEN_BATCH}, prompt {QWEN_PROMPT}, "
          f"gen {QWEN_GEN}, bf16 compute, float32 parameters and RG-LRU "
          f"blocks, window {gmcfg.sliding_window}) on {card}: prefill "
          f"{c_out['prefill_s']:.4f} s, decode {c_out['decode_s']:.4f} s "
          f"({c_out['decode_s'] / QWEN_GEN * 1e3:.2f} ms/step, "
          f"{c_out['decode_tok_per_s']:.1f} tok/s), bf16 weight copy "
          f"{c_out['cast_s']:.4f} s, {rgemma_s:.3f} s wall with the "
          f"weights' init; peak memory {c_mem / 2**30:.2f} GiB; launches "
          f"{dict(zip(KERNELS, counts['recurrentgemma_serve']))}; first "
          f"tokens {c_out['generated'][0, :8].tolist()}")
    del c_out
    torch.cuda.empty_cache()

    # ---- 10. times and bounds ---------------------------------------------
    def time_kernel(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return event_ms(torch, fn, 20)

    def mlp_step_ops(dims, feats):
        """f32 operations of one MLP step that learns: the features (~60
        for "sense"), the forward (a multiply and an add per weight, the
        bias, the ReLU), Q(s, a) and delta, the backward's gradient sums
        and the update (a multiply for the gradient, the step size and
        the subtraction per weight and bias)."""
        pairs = list(zip(dims[:-1], dims[1:]))
        ops = 60 if feats == "sense" else 0
        ops += sum(2 * i * o + 2 * o for i, o in pairs) + 2 * dims[-1] + 1
        ops += sum(2 * i * o + i for i, o in pairs[1:])
        ops += sum(3 * i * o + 2 * o for i, o in pairs)
        return ops

    def episode_numbers(packed, shape):
        """(ms, bound ms, bytes ms, ops ms) of the episode kernel on
        ``packed``: the bytes each input is read and each output written
        once (the weight packs too); per step the fused step's ~200 scalar
        operations, the concurrent slots' reductions, faulted 6 more, and
        the network's (:func:`mlp_step_ops`)."""
        args, kw = packed
        xf, xi, consts, q0, extrema0 = args[:5]
        ms = time_kernel(lambda: soc_kernel.soc_step_episode(*args, **kw))
        nb, ns, nf = xf.shape
        wbytes = 2 * args[5].numel() if len(args) > 5 else 0
        nbytes = 4 * (nb * ns * (nf + 5) + consts.numel() + 2 * q0.numel()
                      + extrema0.numel() + nb * ns * 6 + wbytes)
        flops = nb * ns * (200 + kw["n_threads"] * (9 + 5 * kw["n_tiles"])
                           + (6 if kw["faulted"] else 0)
                           + (mlp_step_ops(kw["mlp_dims"], kw["mlp_feats"])
                              if "mlp_dims" in kw else 0))
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_F32_FLOPS * 1e3
        print(f"{shape} on {card}: kernel {ms:.4f} ms/launch, bound "
              f"{max(by, op):.6f} ms ({nbytes} bytes -> {by:.6f} ms; "
              f"{flops} f32 ops -> {op:.6f} ms); serial chain of {ns} "
              f"dependent steps, {ms / ns * 1e3:.2f} us/step")
        return ms, max(by, op), by, op

    def serve_numbers(packed, shape):
        """The same for the serve kernel: it reads footprint, u_explore,
        tiles, profile, avail, the gumbel and (faulted) the fault columns
        of xf (it makes eps, alpha and the n_accs-wide others block
        itself), acc_id and pre_mode of xi; per request four admission
        attempts over a queue_cap ring, the watchdog and the fused step."""
        (xf, xi, xv, consts, carry), kw = packed
        ms = time_kernel(lambda: soc_kernel.soc_step_serve(
            xf, xi, xv, consts, carry, **kw))
        nb, ns, nf = xf.shape
        carry_bytes = sum(4 * t.numel() for t in carry)
        nbytes = (4 * (nb * ns * ((nf - 2 - s1.n_accs) + 2 + xv.shape[-1]
                                  + len(soc_ref.SERVE_YCOLS))
                       + consts.numel()) + 2 * carry_bytes)
        flops = nb * ns * (4 * (fig11.QUEUE_CAP + 4) + 30 + 200
                           + s1.n_accs * (9 + 5 * s1.n_mem_tiles)
                           + (6 if kw["faulted"] else 0))
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_F32_FLOPS * 1e3
        print(f"{shape} on {card}: kernel {ms:.4f} ms/launch, bound "
              f"{max(by, op):.6f} ms ({nbytes} bytes -> {by:.6f} ms; "
              f"{flops} f32 ops -> {op:.6f} ms); serial chain of {ns} "
              f"dependent requests, {ms / ns * 1e3:.2f} us/request")
        return ms, max(by, op), by, op

    nums = [
        episode_numbers(packed_main, f"soc_step_episode B={b} S={s_len}"),
        serve_numbers(sv_packed, f"soc_step_serve B=4 S={n_req}"),
        episode_numbers(packed_f,
                        f"soc_step_episode_faulted B={b} S={s_len}"),
        serve_numbers(svf_packed, f"soc_step_serve_faulted B=4 S={n_req}"),
        episode_numbers(packed_m, f"soc_step_episode_mlp B={b} S={s_len}"),
        episode_numbers(packed_mf,
                        f"soc_step_episode_mlp_faulted B={b} S={s_len}"),
    ]
    plain = [ep_plain_ms, sv_plain_ms, epf_plain_ms, svf_plain_ms,
             epm_plain_ms, epmf_plain_ms]
    errs = [ep_err, sv_err, epf_err, svf_err, epm_err, epmf_err]
    shapes = [f"B={b} S={s_len}", f"B=4 S={n_req}", f"B={b} S={s_len}",
              f"B=4 S={n_req}", f"B={b} S={s_len}", f"B={b} S={s_len}"]
    for name, ms in zip(SOC_KERNELS, plain):
        print(f"{name}: plain version {ms:.1f} ms on the same inputs; "
              f"library_ms null (no single PyTorch call computes the step)")

    def graph_ms(fn, reps=20):
        """Device ms per call of ``fn``: ``reps`` calls captured in a CUDA
        graph and replayed, so the host's launch work is left out."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return event_ms(torch, graph.replay, 3) / reps

    def plain_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        return event_ms(torch, fn, reps)

    def attention_numbers(shape, q, k, v, causal):
        """(ms, plain ms, SDPA ms, bound ms, bytes ms, ops ms, device ms,
        SDPA device ms, body) of K3 on (q, k, v): ms from 20 launches in a
        row, as every kernel's (the wrapper's host work included where it
        is longer than the kernel), device ms from a CUDA graph of 20
        launches (the host's work left out); the bytes of q, k, v read
        once and the output written once; the operations of the (query,
        key) pairs the mask keeps (a multiply and an add per element of
        QK^T and of PV), at the bf16 tensor-core peak."""
        b, h, hkv, sq, skv, hd = shape
        feat = dict(causal=causal)
        kern = lambda: fa_kernel.flash_attention(q, k, v, **feat)
        # SDPA aligns a causal mask top-left: one query row sees every key
        sdpa = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal and sq > 1, enable_gqa=True)
        plan = fa_kernel.launch(q, k, v, **feat)[1]
        dev_ms, ms = graph_ms(kern), time_kernel(kern)
        lib_dev_ms, lib_ms = graph_ms(sdpa), time_kernel(sdpa)
        pl_ms = plain_ms(lambda: fa_ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **feat))
        pairs = (sq * (skv - sq + 1) + sq * (sq - 1) // 2 if causal
                 else sq * skv)
        flops = 4 * hd * pairs * b * h
        nbytes = q.element_size() * hd * (2 * b * sq * h + 2 * b * skv * hkv)
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_BF16_FLOPS * 1e3
        print(f"flash_attention {shape} bf16 {plan.body} on {card}: kernel "
              f"{ms:.4f} ms/launch (device {dev_ms:.4f} ms: "
              f"{flops / dev_ms / 1e9:.2f} TFLOP/s, "
              f"{nbytes / dev_ms / 1e9:.3f} TB/s), plain {pl_ms:.3f} ms, "
              f"SDPA {lib_ms:.4f} ms (device {lib_dev_ms:.4f}); bound "
              f"{max(by, op):.6f} ms ({nbytes} bytes -> {by:.6f} ms; "
              f"{flops} bf16 ops -> {op:.6f} ms)")
        return (ms, pl_ms, lib_ms, max(by, op), by, op, dev_ms, lib_dev_ms,
                plan.body)

    def fp32_decode_numbers():
        """Float32 decode at Qwen3's shape (a float32 compute dtype's
        serve) through split_decode on CUDA cores and through fp32_prefill
        on the same inputs, which agree within 2e-5: (ms, device ms) of
        each."""
        q, kc, vc = qkv(*FA_DECODE[:6], torch.float32, s_max=FA_DECODE[6])
        k, v = kc[:, :FA_DECODE[4]], vc[:, :FA_DECODE[4]]
        t = {}
        for body in ("split_decode", "fp32_prefill"):
            run = lambda: fa_kernel.launch(q, k, v, body=body)
            out, plan = run()
            if plan.body != body:
                fail(f"float32 decode took {plan.body}, not {body}")
            t[body] = (time_kernel(run), graph_ms(run), out)
        err = (t["split_decode"][2] - t["fp32_prefill"][2]).abs().max().item()
        if err > 2e-5:
            fail(f"float32 decode: the two bodies differ by {err}")
        t = {body: x[:2] for body, x in t.items()}
        print(f"flash_attention {FA_DECODE[:6]} float32 on {card}: "
              + ", ".join(f"{body} {ms:.4f} ms/launch (device {d:.4f})"
                          for body, (ms, d) in t.items())
              + f"; the two agree within {err:.3e}")
        return t

    fa_pre = attention_numbers(FA_PREFILL, qp, kp, vp, True)
    fa_dec = attention_numbers(FA_DECODE[:6], qd, kd, vd, True)
    fa_gr_pre = attention_numbers(FA_GR_PREFILL, *gr_fa["prefill"], True)
    fa_gr_dec = attention_numbers(FA_GR_DECODE[:6], *gr_fa["decode"], True)
    fa_f32_dec = fp32_decode_numbers()

    def scan_numbers(shape, r, k, v, lw, u, s0):
        """(ms, plain ms, bound ms, bytes ms, ops ms) of K5 on the inputs
        the path gives it (a zero initial state passed in): r, k, v, logw,
        u and s0 read once, y and the final state written once; per chunk
        of 16 steps and head, the cumsum, the exponentials and their
        products (8 operations per element of the K-wide rows), the 120
        strictly causal entries of A and their products with v, the bonus,
        q_t S and the state update, in float32."""
        b, h, t, kd = shape
        ms = time_kernel(lambda: rw_kernel.rwkv6_scan(r, k, v, lw, u, s0))
        pl_ms = plain_ms(lambda: rw_ref.wkv_ref(r, k, v, lw, u, s0))
        c = rw_kernel.CHUNK
        pairs = c * (c - 1) // 2
        per_chunk = (8 * c * kd + pairs * 2 * kd + c * 3 * kd
                     + (pairs + c) * 2 * kd + c * 2 * kd * kd + c * kd
                     + kd * kd * (2 * c + 2))
        flops = b * h * (t // c) * per_chunk
        nbytes = 4 * (5 * b * h * t * kd + h * kd + 2 * b * h * kd * kd)
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_F32_FLOPS * 1e3
        print(f"rwkv6_scan {shape} float32 on {card}: kernel {ms:.4f} "
              f"ms/launch ({nbytes / ms / 1e6:.1f} GB/s), plain "
              f"{pl_ms:.3f} ms; bound {max(by, op):.6f} ms ({nbytes} bytes "
              f"-> {by:.6f} ms; {flops} f32 ops -> {op:.6f} ms); library_ms "
              f"null (no single PyTorch call computes the recurrence)")
        return ms, pl_ms, max(by, op), by, op

    rw_num = scan_numbers(RWKV_SCAN, *rw_in)

    def gmm_numbers(what, shape, sizes):
        """(ms, plain ms, cuBLAS ms, bound ms, bytes ms, ops ms) of K4 in
        bf16 at ``shape`` with the path's group ``sizes`` (B, E): the kept
        x rows read once, the weights of every expert that some batch row
        routes to read once, the whole output written once; two
        operations per kept row and weight, at the bf16 tensor-core peak.
        The library call is the dense batched product the reference
        computes, ``torch.matmul`` over the whole buffer (cuBLAS)."""
        b_, e, c, d, f = shape
        x = torch.randn(b_, e, c, d, generator=gmm_gen,
                        device=dev).to(torch.bfloat16)
        w = (torch.randn(e, d, f, generator=gmm_gen, device=dev)
             / d ** 0.5).to(torch.bfloat16)
        ms = time_kernel(lambda: gmm_kernel.moe_gmm(x, w, sizes))
        pl_ms = plain_ms(lambda: gmm_ref.gmm_ref(x, w, sizes))
        lib_ms = time_kernel(lambda: torch.matmul(x, w))
        rows = int(sizes.sum())
        experts = int((sizes.sum(0) > 0).sum())
        nbytes = 2 * (rows * d + experts * d * f + b_ * e * c * f)
        flops = 2 * rows * d * f
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_BF16_FLOPS * 1e3
        print(f"moe_gmm {what} {shape} bf16 on {card}: kernel {ms:.4f} "
              f"ms/launch ({flops / ms / 1e9:.2f} TFLOP/s over {rows} kept "
              f"rows, {experts} experts' weights), plain {pl_ms:.3f} ms, "
              f"cuBLAS matmul {lib_ms:.4f} ms; bound {max(by, op):.6f} ms "
              f"({nbytes} bytes -> {by:.6f} ms; {flops} bf16 ops -> "
              f"{op:.6f} ms)")
        return ms, pl_ms, lib_ms, max(by, op), by, op

    def rglru_numbers(shape, log_a, bb):
        """(ms, plain ms, bound ms, bytes ms, ops ms) of K6 on (log_a, b)
        at the path's prefill shape: log_a and b read once, h and h_final
        written once; an exp, a multiply and an add per element, float32
        (the exp counted as one operation)."""
        b_, t, w = shape
        ms = time_kernel(lambda: rg_kernel.rglru_scan(log_a, bb))
        zeros = torch.zeros((b_, w), device=dev)
        pl_ms = plain_ms(lambda: rg_ref.rglru_ref(log_a, bb, zeros))
        nbytes = 4 * (3 * b_ * t * w + b_ * w)
        flops = 3 * b_ * t * w
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_F32_FLOPS * 1e3
        print(f"rglru_scan {shape} float32 on {card}: kernel {ms:.4f} "
              f"ms/launch ({nbytes / ms / 1e6:.1f} GB/s), plain "
              f"{pl_ms:.3f} ms; bound {max(by, op):.6f} ms ({nbytes} bytes "
              f"-> {by:.6f} ms; {flops} f32 ops -> {op:.6f} ms); library_ms "
              f"null (no single PyTorch call computes the recurrence)")
        return ms, pl_ms, max(by, op), by, op

    rg_num = rglru_numbers(RG_SCAN, *rg_in)
    fa_rg_pre = attention_numbers(FA_RG_PREFILL, *rg_fa["prefill"], True)
    fa_rg_dec = attention_numbers(FA_RG_DECODE, *rg_fa["decode"], True)
    gmm_pre = gmm_numbers("prefill gate/up", GMM_PREFILL, gmm_sizes[0])
    gmm_down = gmm_numbers("prefill down", GMM_DOWN, gmm_sizes[0])
    gmm_dec = gmm_numbers("decode gate/up", GMM_DECODE, gmm_sizes[1])
    paths_s = {"fig6": fig6_s, "fig9": fig9_s, "fig11": fig11_s,
               "fig10": fig10_s, "storm_serving": storm_s, "fig13": fig13_s,
               "qwen3_serve": qwen_s, "rwkv6_serve": rwkv_s,
               "granite_serve": granite_s, "recurrentgemma_serve": rgemma_s}
    print(f"paths on {card}: " + ", ".join(f"{p} {t:.3f} s"
                                           for p, t in paths_s.items()))

    # launches: the sum over the paths; main_path_s: the summed wall time
    # of the paths that launched the kernel
    by_path = lambda j: {p: c[j] for p, c in counts.items()}
    on_paths = lambda j: sum(paths_s[p] for p, c in counts.items() if c[j])
    kernels = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/soc_step/csrc/soc_step.cu",
         "replaces": ("src/repro/kernels/soc_step/kernel.py:258"
                      if "serve" in name
                      else "src/repro/kernels/soc_step/kernel.py:113"),
         "variant": ("mlp_dims, " if "mlp" in name else "")
                    + ("faulted=True" if "faulted" in name else "healthy"),
         "launches": sum(c[j] for c in counts.values()),
         "launches_by_path": by_path(j), "max_abs_err": errs[j],
         "ms": nums[j][0], "plain_ms": plain[j], "bound_ms": nums[j][1],
         "bound_by": "bytes" if nums[j][2] >= nums[j][3] else "operations",
         "library_ms": None, "main_path_s": on_paths(j),
         "shape": shapes[j], "card": card}
        for j, name in enumerate(SOC_KERNELS)], "paths_s": paths_s}
    j = KERNELS.index("flash_attention")
    kernels["kernels"].append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "variant": "bf16, causal: tc_prefill (wgmma, TMA) and split_decode",
        "launches": sum(c[j] for c in counts.values()),
        "launches_by_path": by_path(j), "max_abs_err": fa_err,
        "ms": fa_pre[0], "plain_ms": fa_pre[1], "bound_ms": fa_pre[3],
        "bound_by": "bytes" if fa_pre[4] >= fa_pre[5] else "operations",
        "library_ms": fa_pre[2], "main_path_s": on_paths(j),
        "shape": f"prefill {FA_PREFILL}", "decode_shape": str(FA_DECODE[:6]),
        "decode_ms": fa_dec[0], "decode_plain_ms": fa_dec[1],
        "decode_bound_ms": fa_dec[3],
        "decode_bound_by": ("bytes" if fa_dec[4] >= fa_dec[5]
                            else "operations"),
        "decode_library_ms": fa_dec[2],
        "rg_shape": f"prefill {FA_RG_PREFILL}, window {RG_WINDOW}",
        "rg_ms": fa_rg_pre[0], "rg_plain_ms": fa_rg_pre[1],
        "rg_bound_ms": fa_rg_pre[3], "rg_library_ms": fa_rg_pre[2],
        "rg_decode_shape": str(FA_RG_DECODE), "rg_decode_ms": fa_rg_dec[0],
        "rg_decode_plain_ms": fa_rg_dec[1],
        "rg_decode_bound_ms": fa_rg_dec[3],
        "rg_decode_library_ms": fa_rg_dec[2],
        "gr_shape": f"prefill {FA_GR_PREFILL}", "gr_ms": fa_gr_pre[0],
        "gr_plain_ms": fa_gr_pre[1], "gr_bound_ms": fa_gr_pre[3],
        "gr_library_ms": fa_gr_pre[2],
        "gr_decode_shape": str(FA_GR_DECODE[:6]),
        "gr_decode_ms": fa_gr_dec[0], "gr_decode_plain_ms": fa_gr_dec[1],
        "gr_decode_bound_ms": fa_gr_dec[3],
        "gr_decode_library_ms": fa_gr_dec[2],
        "timing": "ms: 20 launches in a row, as every kernel's; device_ms: "
                  "a CUDA graph of 20 launches replayed",
        "device_ms": {n: x[6] for n, x in (
            ("prefill", fa_pre), ("decode", fa_dec), ("rg", fa_rg_pre),
            ("rg_decode", fa_rg_dec), ("gr", fa_gr_pre),
            ("gr_decode", fa_gr_dec))},
        "library_device_ms": {n: x[7] for n, x in (
            ("prefill", fa_pre), ("decode", fa_dec), ("rg", fa_rg_pre),
            ("rg_decode", fa_rg_dec), ("gr", fa_gr_pre),
            ("gr_decode", fa_gr_dec))},
        "float32_decode_ms": fa_f32_dec,
        "bodies_by_path": fa_bodies, "max_abs_err_by_body": fa_errs,
        "hgmma": hgmma_by_body, "card": card})
    j = KERNELS.index("rwkv6_scan")
    kernels["kernels"].append({
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:69",
        "variant": "float32, chunk 16, initial state passed",
        "launches": sum(c[j] for c in counts.values()),
        "launches_by_path": by_path(j), "max_abs_err": rw_err,
        "ms": rw_num[0], "plain_ms": rw_num[1], "bound_ms": rw_num[2],
        "bound_by": "bytes" if rw_num[3] >= rw_num[4] else "operations",
        "library_ms": None, "main_path_s": on_paths(j),
        "shape": f"(B, H, T, K) {RWKV_SCAN}", "card": card})
    j = KERNELS.index("moe_gmm")
    bound_by = lambda n: "bytes" if n[4] >= n[5] else "operations"
    kernels["kernels"].append({
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:51",
        "variant": "bf16, B x E groups per launch, CUDA-core FMAs",
        "launches": sum(c[j] for c in counts.values()),
        "launches_by_path": by_path(j),
        "max_abs_err": gmm_errs[torch.bfloat16],
        "max_abs_err_float32": gmm_errs[torch.float32],
        "ms": gmm_pre[0], "plain_ms": gmm_pre[1], "bound_ms": gmm_pre[3],
        "bound_by": bound_by(gmm_pre), "library_ms": gmm_pre[2],
        "main_path_s": on_paths(j),
        "shape": f"prefill gate/up (B, E, C, D, F) {GMM_PREFILL}",
        "down_ms": gmm_down[0], "down_plain_ms": gmm_down[1],
        "down_bound_ms": gmm_down[3], "down_bound_by": bound_by(gmm_down),
        "down_library_ms": gmm_down[2],
        "decode_shape": str(GMM_DECODE), "decode_ms": gmm_dec[0],
        "decode_plain_ms": gmm_dec[1], "decode_bound_ms": gmm_dec[3],
        "decode_bound_by": bound_by(gmm_dec),
        "decode_library_ms": gmm_dec[2], "card": card})
    j = KERNELS.index("rglru_scan")
    kernels["kernels"].append({
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:49",
        "variant": "float32, one thread per channel, h0 folded by ops",
        "launches": sum(c[j] for c in counts.values()),
        "launches_by_path": by_path(j), "max_abs_err": rg_err,
        "ms": rg_num[0], "plain_ms": rg_num[1], "bound_ms": rg_num[2],
        "bound_by": "bytes" if rg_num[3] >= rg_num[4] else "operations",
        "library_ms": None, "main_path_s": on_paths(j),
        "shape": f"(B, T, W) {RG_SCAN}", "card": card})
    for k in kernels["kernels"]:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms")
                   if k[f] is not None):
            fail(f"{k['name']}: non-finite timing")
        if (k["launches"] == 0) != (k["name"] in OFF_PATH):
            fail(f"{k['name']} launched {k['launches']} times over the "
                 f"paths: {counts}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
