"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from this checkout, one ``nvcc`` per
source, started together (``soc_step.cu``: ``soc_step_episode`` and
``soc_step_serve``, each in a healthy and a faulted instantiation, and
each kernel's MLP instantiations, healthy and faulted (K1m and K2m);
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
composition; runs its coverage probe (``rwkv6_scan/coverage.py``: logw =
0 and small integer r, k, v, u and state, so every sum is exact and the
kernel must equal its plain version bitwise) at every head dim over one,
two, three and 128 chunks from a zero and a random-integer state; checks
the card against the CPU on the rwkv6 smoke serve
(float32, the reference's zero-initialised ``u``, LoRA-b and ``ln_w`` set
from a seed); and drives an eighth path:

  * rwkv6-3b serving at full width: random float32 weights made on the
    card from a seed, the same 4 prompts of 2,048 tokens and 32 greedy
    tokens, bf16 compute; every time mix of the prefill through K5 (32
    launches), decode through the model's step function, K3 never.

Then it holds the grouped expert-matmul kernel (K4) against its plain
version at the granite serving path's prefill (gate/up and down) and
decode (gate/up and down) shapes and at ``tests/test_kernels.py``'s
shapes, in float32 and bf16, each call through the body its plan names
(``tc_gmm``, ``gemv_decode`` or ``fp32_tiled``) and bitwise equal to a
second launch, with every row past its group's size exactly 0 and each
bf16 body's largest error printed in bf16 ulps of the output; runs the
coverage probe (one or two 1s a row of x, small integer weights: exact)
at the path's prefill gate/up, down and decode shapes; counts the HGMMA
instructions of ``tc_gmm`` and fails on none; checks the card against
the CPU on the granite smoke serve (float32); and drives a ninth path:

  * granite-moe-3b-a800m serving at full width: random float32 weights
    made on the card from a seed, the same 4 prompts of 2,048 tokens and
    32 greedy tokens, bf16 compute; every attention through K3 (32
    ``tc_prefill`` and 32 x 32 ``split_decode`` launches) and every expert
    product through K4 (3 x 32 prefill launches through ``tc_gmm``, 3 x
    32 x 32 decode launches through ``gemv_decode``, asserted), K5 never;
    it prints the prefill's mean drop_frac and the smallest top-k margin
    the router saw.

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

Then it runs the event-driven simulator (``repro_torch.soc.des``), which
launches none of the kernels: on the card against ``device="cpu"`` on
the two single-thread chain apps of ``tests/test_vecenv_equivalence.py``
(the four fixed modes, manual, random, a Q agent trained for two
iterations, a frozen MLP agent and manual under ``storm(18, 1.0)``:
integer traces equal, floats within the tolerance); its timing model's
CUDA graphs, healthy and faulted, bitwise against their eager ops; the
reference's fidelity contract against the batched environment on the
card (modes and states equal, phase times within 1e-4, NON_COH off-chip
counts on two threads, ``compare_policies``' backends within 1e-3); and
three more paths, each with the counts set to 0 before it and all of
them 0 after:

  * Fig. 2 (``benchmarks/torch_fig2_isolation.py``): 12 accelerators x 3
    sizes x 5 one-invocation runs;
  * Fig. 3 (``benchmarks/torch_fig3_parallel.py``): 4 modes x {1, 4, 8,
    12} threads x 6 loops, 600 invocations (also on the CPU, for the
    rate);
  * Fig. 5 ``--fidelity`` (``benchmarks/torch_fig5_phases.py``):
    ``train_cohmeleon`` for 10 iterations of a 529-invocation app, then
    the simulator-profiled suite on the 156-invocation Fig. 5 app.

After Fig. 10's path, a path of its own (counts set to 0 before it and
read after) cross-checks the simulator against the batched environment
under each storm, per phase: 5 healthy and 15 faulted episode launches.

Then the rest of the SoC layer: the simulator's serving mirror
(``SoCSimulator.serve``) on the card against ``device="cpu"`` on one
arrival table per chain app (64 requests at 1.5x capacity into queues
of 4: the four fixed modes, manual, a Q agent learning as it serves and
NON_COH under ``storm(64, 0.7)``; integer fields equal, floats within
the tolerance); ``soc.shard``'s stacked trainer and episodes split in
two chunks on the one card (``devices=[cuda:0, cuda:0]``, ``force``):
bitwise one call, with twice the episode-kernel launches; a small Fig.
12 sweep (6 SoCs) on the card against the CPU, bitwise; the unfused
plain step (``VecEnv(fused_step=False)``) against K1 on a 3-thread
chain app (q, fixed, manual), bitwise and launching nothing; and two
more paths, each with the counts set to 0 before it and read after:

  * Fig. 12 (``benchmarks/torch_fig12_dse.py``): 256 DSE-sampled SoCs in
    4 length buckets, one agent trained per SoC for 3 iterations of a
    3-phase app and the 7-family suite evaluated: 16 episode-kernel
    launches (4 buckets x (3 + 1)), asserted; the largest bucket's
    training (B 108, S 144) and evaluation (B 756, S 368) launches are
    held bitwise against ``ref.episode_ref`` on their own inputs (the
    path's outputs and a second launch's);
  * Fig. 11's DES cross-check (``--fidelity``, ``benchmarks/
    torch_fig11_serving.py``): the batched serving path against the
    serving mirror at 3 loads x the 4 fixed modes, 6,144 requests: 0
    admission mismatches, latencies within the reference's bound; 13
    serve-kernel launches (the probe and 12 streams), asserted.

Then two more paths, each with the counts set to 0 before it and read
after:

  * MLP-agent serving at Fig. 11's shape: on SoC1 and Fig. 11's
    application, a Q-table trained as Fig. 11 trains it (21 episode
    launches) and a (14, 16, 16, 4) sense network (Fig. 13's MLPConfig)
    trained through K1m for as many iterations (10); then four policies
    in one batch, the learning network, its frozen copy, the Q-table and
    fixed NON_COH (the last two with placeholder networks), serve 1,024
    requests at Fig. 11's five offered loads (5 K2m launches) and under
    ``storm(1024, 0.7, PRNGKey(42))`` (1 K2m-faulted), asserted; every
    launch is held bitwise against ``ref.serve_episode_ref`` on its own
    inputs (traces and carries, packs included), the learning network's
    pack must move and the frozen one's stay.  After it the card is held
    against the CPU on a small MLP stream (SoC1, 128 requests,
    overloaded, under a storm) and a checkpointed MLP stream killed after
    one of three chunks is resumed, bitwise the uninterrupted one;
  * gemma2-9b serving at full width, after K3 is held against its plain
    version at the path's prefill (4, 16 over 8 kv heads, 2,048, head dim
    256; causal and window 4,096) and decode (one row over 2,049 of
    2,080 rows) shapes with soft-cap 50, in bf16 and float32, and its
    coverage probes run there, and after the card is held against the
    CPU on the Gemma-2 smoke serve: random float32 weights (9.24 B
    parameters) made on the card from a seed, the same 4 prompts of
    2,048 tokens and 32 greedy tokens, bf16 compute, every attention
    through K3 with soft-cap 50 (42 ``tc_prefill`` and 42 x 32
    ``split_decode`` launches, asserted), finite logits inside the final
    soft-cap of 30; the peak memory is printed.

Then it holds K3 against its plain version at qwen2-vl-2b's shapes (12
query heads over 2 kv heads of 128: group 6) and musicgen-large's (32
heads over 32 kv heads of 64: group 1), prefill and decode, in bf16 and
float32, with the coverage probes of the tensor-core prefill and of the
split decode (1, 4 and 7 query rows) at both; holds a bf16 smoke serve
(Qwen3's smoke config at head dim 64, a prompt of 80 tokens, so the
plans pick ``tc_prefill`` and the bf16 ``split_decode``, asserted) on the
card against the CPU, the card decoding the CPU's tokens, every step's
logits within 2e-2; holds arctic-480b's smoke serve (the dense residual
MLP beside the MoE, float32: K4 through ``fp32_tiled``, K3 in float32)
on the card against the CPU (tokens equal, logits within 1e-5), its
launches counted; and drives three more LM paths and three fidelity
paths, each with the counts set to 0 just before it and read just
after:

  * qwen2-vl-2b serving at full width (M-RoPE over (16, 24, 24) rotary
    sections, 256 projected vision-stub embeddings of width 1,280 over
    the first positions): the LM paths' traffic and weights' rule; 28
    ``tc_prefill`` and 28 x 32 ``split_decode`` K3 launches, asserted;
  * musicgen-large serving at full width (4 audio codebooks, sinusoidal
    positions, GeLU, full multi-head attention): 48 and 48 x 32;
  * Qwen3-8B serving with the int8 KV cache: 36 and 36 x 32; then the
    bf16 cache's path again beside it (the same counts), so the two
    prefill and decode times and peaks (above the memory the script
    holds) compare warm, and both caches' bytes;
  * Fig. 6 ``--fidelity`` (``benchmarks/torch_fig6_reward_dse.py``
    ``des_points``) at full SoC and app width, cut to the first 2 of 15
    weightings x 2 of 10 iterations: no launch, and the batched path's
    classification of the same weightings (2 seeds; 3 episode launches)
    must equal it (``des_agreement``; 4 episode launches: 2 training,
    the NON_COH baseline and the frozen agents);
  * Fig. 9's cross-check (``torch_fig9_socs.crosscheck_port``) on all 8
    lanes: one episode launch against the simulator's replays,
    ``agree``;
  * Fig. 9 ``--fidelity`` (``torch_fig9_socs.run_des``) on SoC1-mixed, 1
    of 8 lanes, x 2 of 10 iterations: no launch.

Then LM training.  It holds the gradient of each kernel's autograd
wrapper (the kernel forward, autodiff of its plain version backward)
against autodiff through the plain version on the same inputs (the
forward bound checks the kernel; the gradient bound only the wrapper's
wiring, as both sides are autodiff of the same plain version): K3 at
qwen2-vl-2b's training shape (B 4, S 2,048, H 12, Hkv 2, hd 128, bf16,
causal), K4 at granite's prefill gate/up shape, K5 at rwkv6-3b's prefill
shape cut to T 512 (the plain recompute steps T times), K6 at
recurrentgemma-9b's prefill shape; it holds the card against the CPU at
smoke width (float32, B 2, seq 16: one step's loss and every gradient,
the parameters after 5 train steps) on granite (K3, K4), rwkv6 (K5),
recurrentgemma (K6, K3), qwen2-vl-2b (K3), Qwen3 with int8 gradient
compression and arctic-480b (Adafactor, remat "full": every kernel
launched again in the backward pass), each run's launches asserted; and
drives, each with the counts set to 0 before it and read after:

  * qwen2-vl-2b training at full width through ``repro_torch.launch.
    train``: random float32 weights from seed 0 made on the card, bf16
    compute, AdamW with float32 moments, 4 synthetic sequences of 2,048
    tokens for 6 steps; a finite gradient for every parameter at step 1,
    a finite loss at every step, 28 ``tc_prefill`` K3 launches a step
    (asserted); the step time (median of steps 2-6) split into forward,
    backward and optimizer, tokens a second and the peak memory above
    what the script held;
  * the same for 2 steps under each remat arm (``none``, ``dots``,
    ``full``: 28, 56 and 56 K3 launches a step), the second step timed,
    the ``dots`` and ``full`` arms' step-1 loss and gradient norm within
    1e-6 (relative) of ``none``'s: the selective-checkpoint policy, the
    kernels and their wrappers' recomputing backward held together;
  * the memory-mode autotuner (``core.autotune``) for 40 steps of
    Qwen3-8B's smoke config: the top arm at least half the decisions, a
    decide overhead under 0.1 s;
  * a smoke ``launch.train`` run with checkpoints every 2 steps, killed
    in step 4 and resumed, bitwise the uninterrupted run (losses and
    every checkpoint leaf; PyTorch's deterministic algorithms on, as the
    card's scatter-adds otherwise add in any order).

``chiprun_out/lm_training_port.json`` keeps these numbers; the
``kernels`` line gives K3-K6 their training launches by path.

Then the distributed layer (``# ---- 9z.``): a probe
(``benchmarks/torch_mesh_probe.py``) starts two ranks on the one card
over gloo and tries, on CUDA tensors, the collectives a DTensor program
issues, then a one-rank NCCL DTensor round trip, which must succeed.
The probe's first reading decided how the mesh phases run on the card:
gloo aborts a process handed CUDA memory and NCCL refuses two ranks on
one device, so no phase runs two ranks here (the script does not switch
on the probe's answer; the sharded arithmetic is held against the
reference on 4 CPU ranks, ``tests/test_torch_mesh_*.py``).  It drives,
with the counts set to 0 before and read after:

  * qwen2-vl-2b training at full width through ``launch.train
    --data-mesh 1 --model-mesh 1``: the same seed-0 weights, batches and
    4 x 2,048 tokens as the plain run above, the state placed by
    ``train_shardings`` as DTensors on a one-rank NCCL mesh, 3 steps; 28
    ``tc_prefill`` K3 launches a step, each through ``local_map`` (the
    wrapper's ``shard_calls``), step 1's loss and gradient norm within
    1e-6 (relative) of the plain run's; the step time (median of steps
    2-3, DTensor's host dispatch included) beside the plain step's, and
    the peak memory.

Then the dry-run (``# ---- 9za.``, ``dryrun_phase``): three
subprocesses trace on PyTorch's fake process group with fake CUDA
tensors (``repro_torch.launch.dryrun``), Qwen3-8B's train_4k,
prefill_32k and decode_32k cells on 16 x 16 = 256 ranks and its train
cell on 2 x 16 x 16 = 512 (``--no-cost``), each cell's roofline terms
printed and written under ``chiprun_out/dryrun_torch/``, and
qwen2-vl-2b's train step at (1, 1) and 4 x 2,048 tokens; meanwhile, with
the counts set to 0 before and read after, it drives:

  * one more qwen2-vl-2b train step at full width on the one-rank NCCL
    (1, 1) mesh, untimed, under ``repro_torch.launch.roofline.Counter``:
    its FLOPs, bytes moved, collective bytes, argument bytes and 28 K3
    launches must equal the fake trace's; the counted FLOPs over 9z's
    median step give the step's TFLOP/s and its share of the bf16 peak,
    printed beside the card's name and power limit.

The faulted MLP instantiation runs on no path (the reference runs MLP
agents under faults in no figure); it is held against its plain version
and reported with 0 launches.  Every SoC kernel must equal its plain
version bitwise; the episode kernel is also held bitwise against the
CPU plain version over a grid of slot and tile counts (``coverage.
coverage_case``), at ring edges and with both MLP embeddings, and the
serve kernel, healthy and faulted, on an edge grid (``coverage.
serve_edge_case``: a full queue under a priority reserve, retries,
deadline misses, a watchdog that trips and releases) in one launch and
in three chained ones, and so the MLP serve kernel (K2m, K2m-faulted:
a step warp and a network warp a stream) on the MLP edge grid
(``coverage.serve_mlp_edge_case``: a learning network, its frozen copy,
a table and NON_COH beside placeholders, a +inf Q-value, the watchdog,
at the sense network K2m keeps in registers, a one-hot and the widest
network in shared memory), packs included.  It times the episode kernel
at each path's shapes, recorded as the paths launch it, beside its chain
bound (``kernel.chain_cycles`` at the SM clock), and the serve kernel
beside its own (``kernel.serve_chain_cycles``; K2m's also as the
one-warp body's count), K2 and K2m at Fig. 11's 0.2x and 2x loads and
K2f and K2m-faulted under the storm; with ``--parent DIR`` (a ``git
archive`` of another commit) it builds that commit's ``soc_step.cu`` and
``rwkv6_scan.cu`` too and times its episode, serve and scan kernels on
the same arguments in turns (parent, this, this, parent), after checking
their outputs bitwise equal (the scan's within the tolerance), and runs
Fig. 11 and storm serving again through that commit's SoC kernels, whose
results must equal this run's (``chiprun_out/*_parent_kernels.json``).

It checks each path's kernel launch counts and finite outputs, prints the
paths' headline numbers and wall times, and times each kernel, its plain
version, its bound and, for K3 (at the Qwen3, granite, recurrentgemma,
gemma2-9b, qwen2-vl-2b and musicgen-large prefill and decode shapes
(SDPA without gemma2's soft-cap, which no PyTorch call applies), as 20
launches in a row, the ``ms`` of every kernel, and as the device time of a CUDA graph of 20 launches), PyTorch's
``scaled_dot_product_attention`` on the same inputs, for K4 (at the
granite path's prefill gate/up and down and decode gate/up and down
shapes, also as the device time of a CUDA graph of 20 launches, beside
its CUDA-core body ``fp32_tiled`` on the same inputs) cuBLAS's dense batched
product over the whole buffer (no single PyTorch call computes the SoC
step, the WKV or the RG-LRU recurrence).  Exits non-zero,
printing no result, without a CUDA card or outside a checkout of the
repository.  ``chiprun_out/lm_serving_port.json`` and
``chiprun_out/fidelity_port.json`` keep the new paths' numbers.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it lists
every ported kernel with its numbers.
"""
from __future__ import annotations

import copy
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
H100_F64_TC_FLOPS = 67e12     # float64 on the tensor cores (data sheet)
H100_F64_FLOPS = 34e12        # float64 outside the tensor cores
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
           "moe_gmm", "rglru_scan", "soc_step_serve_mlp",
           "soc_step_serve_mlp_faulted")
SOC_KERNELS = KERNELS[:6] + KERNELS[10:]


def launches(**by_name) -> tuple:
    """A launch-count tuple in :data:`KERNELS` order, 0 where unnamed."""
    return tuple(by_name.get(k, 0) for k in KERNELS)
# held against their plain versions only: no path of the reference runs
# an MLP agent under faults
OFF_PATH = ("soc_step_episode_mlp_faulted",)
# the episode kernel's coverage grid of slot and tile counts
COVER_T, COVER_TILES = (1, 7, 16, 31, 32, 33, 64), (1, 2, 4, 16)
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
# gemma2-9b's serving path: 16 heads over 8 kv heads of 256, soft-cap 50;
# its local layers' window (4,096) is longer than the path's 2,080 rows
FA_GM_PREFILL = (QWEN_BATCH, 16, 8, QWEN_PROMPT, QWEN_PROMPT, 256)
FA_GM_DECODE = (QWEN_BATCH, 16, 8, 1, QWEN_PROMPT + 1, 256,
                QWEN_PROMPT + QWEN_GEN)
GM_SOFTCAP, GM_WINDOW = 50.0, 4096
FA_RG_DECODE = (QWEN_BATCH, 16, 1, 1, RG_WINDOW, 256)
# K3 at the granite-moe-3b-a800m serving path's shapes: 24 query heads over
# 8 kv heads of 64, the same prompt and cache as Qwen3's
FA_GR_PREFILL = (QWEN_BATCH, 24, 8, QWEN_PROMPT, QWEN_PROMPT, 64)
FA_GR_DECODE = (QWEN_BATCH, 24, 8, 1, QWEN_PROMPT + 1, 64,
                QWEN_PROMPT + QWEN_GEN)
# every bf16 K3 launch on an LM path goes through one of these bodies
FA_BF16_BODIES = ("tc_prefill", "split_decode")
# K3 at qwen2-vl-2b's serving path's shapes (12 query heads over 2 kv heads
# of 128: group 6) and musicgen-large's (32 heads over 32 kv heads of 64:
# group 1, full multi-head attention), the same prompt and cache as Qwen3's
FA_VL_PREFILL = (QWEN_BATCH, 12, 2, QWEN_PROMPT, QWEN_PROMPT, 128)
FA_VL_DECODE = (QWEN_BATCH, 12, 2, 1, QWEN_PROMPT + 1, 128,
                QWEN_PROMPT + QWEN_GEN)
FA_MG_PREFILL = (QWEN_BATCH, 32, 32, QWEN_PROMPT, QWEN_PROMPT, 64)
FA_MG_DECODE = (QWEN_BATCH, 32, 32, 1, QWEN_PROMPT + 1, 64,
                QWEN_PROMPT + QWEN_GEN)
# the bf16 smoke serve, card against CPU: Qwen3's smoke config at head dim
# 64 in bf16, a prompt long enough for the tensor-core prefill's 64 rows;
# each step's logits within the reference's bf16 bound
BF16_PROMPT, BF16_GEN, BF16_TOL = 80, 8, 2e-2
# the fidelity paths' depth cuts (full SoC and app width): Fig. 6 at the
# first 2 of 15 weightings x 2 of 10 iterations; Fig. 9's _run_des on one
# of 8 lanes x 2 of 10 iterations; Fig. 9's cross-check on all 8 lanes
FID6_WEIGHTS, FID6_ITERS = 2, 2
FID9_LANE, FID9_ITERS = ("SoC1", "mixed"), 2
# LM training: qwen2-vl-2b at full width, 4 sequences of 2,048 tokens for
# 6 steps; K3's gradient check at that training shape (B, S, H, Hkv, hd),
# K5's at rwkv6-3b's prefill cut to T 512 (the plain recompute steps T
# times); the gradients of each kernel's wrapper within 1e-6 of their
# largest magnitude of autodiff through its plain version (the backward
# recomputes it); card against CPU at smoke width (float32, seq 16): one
# step's loss (LM_TOL), every gradient within 1e-4 of each tensor's
# largest magnitude and the parameters after 5 steps within 1e-4 of it
# (at least 1e-2); each remat arm runs 2 steps, the second one timed,
# from the same weights on the same batches: its step-1 loss and gradient
# norm within 1e-6 (relative) of remat "none"'s (the card's scatter-adds
# add in any order, so not bitwise)
VL_SEQ, VL_STEPS, VL_ARM_STEPS = 2048, 6, 2
REMAT_TOL = 1e-6
FA_VL_TRAIN = (QWEN_BATCH, 12, 2, VL_SEQ, 128)
RWKV_TRAIN = (QWEN_BATCH, 40, 512, 64)
GRAD_CHECK_TOL = 1e-6
SMOKE_SEQ, SMOKE_STEPS = 16, 5
SMOKE_GRAD_TOL, SMOKE_PARAM_TOL = 1e-4, 1e-4
TRAIN_KERNELS = ("flash_attention", "moe_gmm", "rwkv6_scan", "rglru_scan")


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


def same_carry(torch, a, b) -> bool:
    """Two serve carries bitwise equal, leaf by leaf (a table stream's
    ``wpack`` is None in both)."""
    return all((x is None and y is None)
               or (x is not None and y is not None and torch.equal(x, y))
               for x, y in zip(a, b))


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


def load_parent_kernel(parent: Path, name: str = "soc_step"):
    """The ``name`` kernel's wrapper module of another checkout
    (``--parent``), as a module of its own: it builds that checkout's
    source into this checkout's build directory, keyed by that source."""
    import importlib.util
    path = parent / "src" / "repro_torch" / "kernels" / name / "kernel.py"
    if not path.exists():
        fail(f"--parent {parent}: no {path.relative_to(parent)}")
    spec = importlib.util.spec_from_file_location(f"parent_{name}_kernel",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


MESH_STEPS = 3
MESH_TOL = 1e-6       # step 1 at (1, 1) against the plain step, relative


def mesh_phase(torch, np, card, vl, plain_row, lm_train, fa_ops,
               reset_counts, read, counts) -> dict:
    """Section 9z: the two-rank probe, then qwen2-vl-2b (``vl``) trained
    at full width on a (1, 1) mesh, held against ``plain_row``, the plain
    run's numbers on the same weights and batches."""
    import torch.distributed as dist
    from benchmarks import torch_mesh_probe
    torch.cuda.empty_cache()      # room for the probe's two processes
    t_p = time.perf_counter()
    probe = torch_mesh_probe.probe()
    probe_s = time.perf_counter() - t_p
    print(f"mesh probe on {card} ({probe_s:.1f} s): {json.dumps(probe)}")
    if probe["nccl_one_rank"].get("dtensor_1x1") != "ok":
        fail(f"mesh probe: the one-rank NCCL round trip failed: "
             f"{probe['nccl_one_rank']}")
    # decided from the probe's first reading (PERF.md §6): no phase
    # runs two ranks on the one card
    print(f"mesh phases on {card}: (1, 1) only; two ranks on one card "
          f"{'would' if probe['two_ranks_on_one_card'] else 'do not'} "
          f"pass the probe")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t_m = time.perf_counter()
    out = lm_train.run(vl, steps=MESH_STEPS, batch=QWEN_BATCH, seq=VL_SEQ,
                       log_every=1, device="cuda", timed=True,
                       data_mesh=1, model_mesh=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_m
    path = "qwen2vl_train_mesh_1x1"
    counts[path] = read()
    want = MESH_STEPS * vl.n_layers
    bodies, through = dict(fa_ops.body_launches), fa_ops.shard_calls
    if (counts[path] != launches(flash_attention=want)
            or bodies["tc_prefill"] != want or through != want):
        fail(f"{path} launched {dict(zip(KERNELS, counts[path]))}, K3 "
             f"bodies {bodies}, {through} through local_map; expected "
             f"{want} tc_prefill, each through local_map")
    mesh = out["mesh"]
    if mesh is None or tuple(mesh.shape) != (1, 1):
        fail(f"{path}: no (1, 1) mesh ({mesh})")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    d_loss = rel(out["losses"][0], plain_row["losses"][0])
    d_norm = rel(out["grad_norms"][0], plain_row["grad_norms"][0])
    if not (d_loss <= MESH_TOL and d_norm <= MESH_TOL
            and all(math.isfinite(x) for x in out["losses"])):
        fail(f"{path}: step 1 loss {out['losses'][0]!r} and gradient norm "
             f"{out['grad_norms'][0]!r} against the plain step's "
             f"{plain_row['losses'][0]!r} and {plain_row['grad_norms'][0]!r}"
             f"; losses {out['losses']}")
    mem = torch.cuda.max_memory_allocated()
    med = lambda xs: float(np.median(xs))
    timed = out["phases"][1:] or out["phases"]
    row = dict(
        probe=probe, probe_s=probe_s, steps=MESH_STEPS, batch=QWEN_BATCH,
        seq=VL_SEQ, losses=out["losses"], grad_norms=out["grad_norms"],
        step1_vs_plain=dict(loss=d_loss, grad_norm=d_norm),
        step_s=med(out["step_s"][1:]), plain_step_s=plain_row["step_s"],
        forward_s=med([p["forward"] for p in timed]),
        backward_s=med([p["backward"] for p in timed]),
        optimizer_s=med([p["optimizer"] for p in timed]),
        own_peak_gib=(mem - base) / 2**30, peak_gib=mem / 2**30,
        plain_own_peak_gib=plain_row["own_peak_gib"],
        k3_per_step=want // MESH_STEPS, shard_calls=through, wall_s=wall)
    print(f"{path} ({vl.name}, B={QWEN_BATCH}, seq {VL_SEQ}, bf16 compute, "
          f"the state as DTensors on a one-rank NCCL mesh, {MESH_STEPS} "
          f"steps) on {card}: step 1 loss within {d_loss:.3e} and gradient "
          f"norm within {d_norm:.3e} of the plain step's (relative; bound "
          f"{MESH_TOL}); step {row['step_s']:.4f} s (median of steps 2-"
          f"{MESH_STEPS}: forward {row['forward_s']:.4f}, backward "
          f"{row['backward_s']:.4f}, optimizer {row['optimizer_s']:.4f}) "
          f"against the plain step's {plain_row['step_s']:.4f} s; peak "
          f"{row['own_peak_gib']:.2f} GiB above what the script held "
          f"(plain {plain_row['own_peak_gib']:.2f}); K3 "
          f"{row['k3_per_step']} tc_prefill launches a step, every one "
          f"through local_map; {wall:.1f} s wall")
    if dist.is_initialized():
        dist.destroy_process_group()
    return row


# the dry-run phase (9za): Qwen3-8B's three cells on a 256-rank fake group
# and its train cell traced on 512 ranks, each cell's terms printed; the
# counted (1, 1) qwen2-vl-2b step against its fake trace
DRYRUN_ARCH = "qwen3-8b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT = 300
_DRYRUN_SINGLE = """
import sys
from repro_torch.launch import dryrun
for shape in sys.argv[3:]:
    dryrun.run_cell(sys.argv[1], shape, report_dir=sys.argv[2])
"""
_DRYRUN_1X1 = """
import json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
spec = ShapeSpec("qwen2vl_1x1", "train", int(sys.argv[2]), int(sys.argv[3]))
step, args, *_ = dryrun.lower_cell(None, None, cfg=get_arch(sys.argv[1]),
                                   spec=spec, mesh_shape=(1, 1))
c = dryrun.count_step(step, args)
print(json.dumps(dict(flops=c.flops, bytes=c.bytes, coll=c.coll,
                      kernels=dict(c.kernels), by_op=c.by_op,
                      peak_bytes=c.peak_bytes,
                      arg_bytes=dryrun.argument_bytes(args),
                      device_type=dryrun.device_type())))
"""


def dryrun_phase(torch, card, vl, step_s, reset_counts, read, counts,
                 fa_ops) -> dict:
    """Section 9za: the dry-run's cells in subprocesses (one fake world a
    process: 256 ranks, 512, and one for the (1, 1) cell), meanwhile one
    more qwen2-vl-2b step at full width on the card's one-rank (1, 1)
    mesh under the roofline counter, untimed; its FLOPs, bytes and kernel
    launches must equal the fake trace of the same cell.  ``step_s`` is
    9z's median step; the counted FLOPs over it give the step's rate."""
    import os
    import torch.distributed as dist
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.synthetic import DataConfig, host_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as lm_steps
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    py = sys.executable
    cmds = {
        "single": [py, "-c", _DRYRUN_SINGLE, DRYRUN_ARCH, str(out_dir),
                   *DRYRUN_SHAPES],
        "multi": [py, "-m", "repro_torch.launch.dryrun", "--arch",
                  DRYRUN_ARCH, "--shape", DRYRUN_SHAPES[0], "--mesh",
                  "multi", "--no-cost", "--report-dir", str(out_dir)],
        "1x1": [py, "-c", _DRYRUN_1X1, vl.name, str(VL_SEQ),
                str(QWEN_BATCH)]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    try:
        # the same cell on the card, while the CPUs trace
        spec = ShapeSpec("qwen2vl_1x1", "train", VL_SEQ, QWEN_BATCH)
        torch.cuda.empty_cache()
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        state_sh, batch_sh = lm_steps.train_shardings(vl, mesh, spec)
        state = lm_steps.place_state(
            lm_steps.make_train_state(vl, 0, "cuda"), state_sh)
        want = lm_steps.input_specs(vl, spec)
        host = host_batch(vl, DataConfig(VL_SEQ, QWEN_BATCH), 0)
        if sorted(host) != sorted(want):
            fail(f"dry-run phase: batch keys {sorted(host)} != "
                 f"{sorted(want)}")
        batch = shd.place({k: torch.from_numpy(host[k]).to(want[k].dtype)
                           for k in want}, batch_sh)
        step = lm_steps.make_train_step(vl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        counter = roofline.Counter()
        with counter:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        counts["qwen2vl_train_counted_1x1"] = read()
        card_peak = torch.cuda.max_memory_allocated() - base
        real = dict(flops=counter.flops, bytes=counter.bytes,
                    coll=counter.coll, kernels=dict(counter.kernels),
                    peak_bytes=counter.peak_bytes,
                    arg_bytes=dryrun.argument_bytes((state, batch)),
                    loss=float(metrics["loss"]))
        del state, batch, metrics
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        res = {}
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=DRYRUN_TIMEOUT)
            res[k] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for k, (rc, stdout, stderr) in res.items():
        (out_dir.parent / f"dryrun_{k}.log").write_text(stdout + stderr)
    bad = {k: r for k, r in res.items() if r[0] != 0}
    if bad:
        fail("; ".join(f"dry-run {k} exited {rc}: {stderr[-1500:]}"
                       for k, (rc, _, stderr) in bad.items()))
    for line in res["single"][1].splitlines() + res["multi"][1].splitlines():
        if line.startswith(("---", "T_comp")):
            print(f"dryrun {line}")
    cells = {}
    for shape in DRYRUN_SHAPES:
        for mesh_name in ("pod16x16", "pod2x16x16"):
            path = out_dir / f"{DRYRUN_ARCH}__{shape}__{mesh_name}.json"
            if path.exists():
                cells[f"{shape}|{mesh_name}"] = json.loads(path.read_text())
    single = [cells.get(f"{s}|pod16x16") for s in DRYRUN_SHAPES]
    multi = cells.get(f"{DRYRUN_SHAPES[0]}|pod2x16x16")
    if (None in single or multi is None
            or not all(c["hlo_flops"] > 0 for c in single + [multi])
            or single[0]["coll_bytes"] <= 0 or multi["coll_bytes"] <= 0
            or any(c["device_type"] != "cuda" for c in single + [multi])):
        fail(f"dry-run cells: {sorted(cells)}: {single} {multi}")
    fake = json.loads(res["1x1"][1].strip().splitlines()[-1])
    same = all(real[k] == fake[k] for k in ("flops", "bytes", "coll",
                                            "kernels", "arg_bytes"))
    if not same or fake["device_type"] != "cuda":
        (out_dir.parent / "dryrun_1x1_by_op.json").write_text(json.dumps(
            {"card": counter.by_op, "fake": fake["by_op"]}, indent=1))
        fail(f"dry-run (1, 1): the card's count {real} differs from the "
             f"fake trace's {({k: v for k, v in fake.items() if k != 'by_op'})}"
             " (by op: chiprun_out/dryrun_1x1_by_op.json)")
    k3 = KERNELS.index("flash_attention")
    if counts["qwen2vl_train_counted_1x1"] != launches(
            flash_attention=vl.n_layers) or fake["kernels"] != {
            "flash_attention": vl.n_layers}:
        fail(f"dry-run (1, 1): K3 launched "
             f"{counts['qwen2vl_train_counted_1x1'][k3]} times on the card,"
             f" the trace counted {fake['kernels']}; expected "
             f"{vl.n_layers}")
    tflops = real["flops"] / step_s / 1e12
    row = dict(cells=cells, counted_1x1=real, fake_1x1={
        k: v for k, v in fake.items() if k != "by_op"},
        step_s=step_s, achieved_tflops=tflops,
        peak_share=tflops * 1e12 / roofline.PEAK_FLOPS,
        card_peak_bytes=card_peak, wall_s=wall, card=card)
    print(f"dry-run (1, 1) {vl.name} train step (B={QWEN_BATCH}, seq "
          f"{VL_SEQ}) on {card}: the card counted {real['flops']:,} FLOPs, "
          f"{real['bytes']:,} bytes, K3 {real['kernels']} launches, equal "
          f"to the fake trace's on {fake['device_type']} tensors; "
          f"{tflops:.2f} TFLOP/s over 9z's median step {step_s:.4f} s = "
          f"{row['peak_share'] * 100:.2f}% of {roofline.PEAK_FLOPS / 1e12:g}"
          f" TFLOP/s (card {card}); traced peak {real['peak_bytes'] / 2**30:.2f}"
          f" GiB above the arguments' {real['arg_bytes'] / 2**30:.2f} GiB, "
          f"card peak {card_peak / 2**30:.2f} GiB above what the script "
          f"held; phase {wall:.1f} s")
    return row


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    argv = sys.argv[1:]
    if argv and (len(argv) != 2 or argv[0] != "--parent"):
        fail("usage: python3 chip_smoke.py [--parent DIR]")
    parent = Path(argv[1]).resolve() if argv else None
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
        from benchmarks import torch_fig2_isolation as fig2
        from benchmarks import torch_fig3_parallel as fig3
        from benchmarks import torch_fig5_phases as fig5
        from benchmarks import torch_fig6_reward_dse as fig6d
        from repro_torch.data.synthetic import DataConfig, host_batch
        from repro_torch import random as prng
        from repro_torch.configs import get_arch, smoke_config
        from repro_torch.kernels import nvcc
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.rwkv6_scan import coverage as rw_cov
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
        from repro_torch.kernels.soc_step import coverage
        from repro_torch.kernels.soc_step import kernel as soc_kernel
        from repro_torch.kernels.soc_step import ops as soc_ops
        from repro_torch.kernels.soc_step import ref as soc_ref
        from repro_torch.soc import apps, faults, traffic, vecenv as vec
        from repro_torch.soc import dse, nn as socnn
        from repro_torch.soc.config import SOC_MOTIV_PAR, SOCS
        from repro_torch.soc.stacked import StackedVecEnv
        from repro_torch.soc import des
        from repro_torch.soc.config import SOC_MOTIV_ISO
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
    parent_kernel = parent_rw = None
    if parent is not None:
        # the parent commit's SoC step and RWKV-6 scan kernels, timed in
        # turns with this checkout's
        parent_kernel = load_parent_kernel(parent)
        parent_rw = load_parent_kernel(parent, "rwkv6_scan")
        sources += (parent_kernel, parent_rw)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = [pool.submit(timed_build, m) for m in sources]
        for f in builds:
            lib, secs = f.result()
            print(f"build: {lib.relative_to(ROOT)} in {secs:.2f} s")
    print(f"builds: {time.perf_counter() - t0:.2f} s for all "
          f"{len(sources)}")
    # the tensor-core bodies (K3's, K4's tc_gmm) must compile to warpgroup
    # MMAs (HGMMA)
    def hgmma_counts(mod, bodies):
        sass = subprocess.run(
            [str(Path(nvcc.find_nvcc()).parent / "cuobjdump"), "-sass",
             str(mod.build())], capture_output=True, text=True)
        if sass.returncode != 0:
            fail(f"cuobjdump: {sass.stderr.strip()}")
        hgmma, fn = {}, None
        for line in sass.stdout.splitlines():
            if "Function : " in line:
                fn = line.split("Function : ")[1].strip()
                hgmma[fn] = 0
            elif fn is not None and "HGMMA" in line:
                hgmma[fn] += 1
        counts = {}
        for name, mangled_part in bodies:
            mangled = [f for f in hgmma if mangled_part in f]
            if len(mangled) != 1:
                fail(f"{mod.__name__}: no single {name} in {sorted(hgmma)}")
            counts[name] = hgmma[mangled[0]]
            if counts[name] == 0:
                fail(f"{mod.__name__} {name} has no HGMMA")
        return counts

    hgmma_by_body = hgmma_counts(fa_kernel, [
        (f"{body}<{hd}>", f"{body}ILi{hd}E")
        for body in ("tc_prefill_kernel", "tc_decode_kernel")
        for hd in (64, 128, 256)])
    print(f"flash_attention HGMMA instructions in the SASS: {hgmma_by_body}")
    gmm_hgmma = hgmma_counts(gmm_kernel, [("tc_gmm_kernel",
                                           "tc_gmm_kernel")])
    print(f"moe_gmm HGMMA instructions in the SASS: {gmm_hgmma}")

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
        if err != 0.0:
            fail(f"{what}: not bitwise equal to the plain version (max abs "
                 f"err {err})")
        print(f"{what} B={n} S={xs.acc_id.shape[1]}: integer traces equal, "
              f"max abs err {err:.3e} (bitwise)")
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

    # ---- 2d. the episode kernel bitwise over the slot and tile grid: K1
    # and K1f at every T x n_tiles of COVER_T x COVER_TILES (one slot, a
    # lane's two slots past 32, one and 16 tiles), learned and manual
    # episodes, ddr and gated on and off, S = 37 over two ring chunks; S =
    # 1, 33 and 65 at Fig. 6's T and tiles; K1m and K1m faulted with both
    # embeddings, a network and a table episode in one launch -------------
    def coverage_vs_plain(c, ddr=False, gated=False, mlp=None, qfun=None):
        """One launch on a ``coverage.coverage_case`` against
        ``ref.episode_ref`` on the CPU: every output bitwise equal."""
        b_ = c.qtable0.shape[0]
        xf, xi = soc_ref.pack_inputs(c.xs)
        consts = soc_ref.pack_consts(
            c.static, c.learned, c.weights, b_, dev,
            *(() if mlp is None else (qfun, mlp.lr)))
        kw = dict(n_threads=c.xs.others.shape[-1],
                  n_tiles=c.xs.tiles.shape[-1], n_actions=4,
                  ddr_attribution=ddr, gated=gated, faulted=c.xs.faulted)
        args, mkw = (xf, xi, consts, c.qtable0, c.extrema0), {}
        cpu = lambda t: t.cpu()
        if mlp is not None:
            args += (mlp.wpack.contiguous(),)
            kw.update(mlp_dims=socnn.mlp_dims(mlp.cfg),
                      mlp_feats=mlp.cfg.features)
            mkw = dict(wpack0=cpu(mlp.wpack), qfun=cpu(qfun),
                       mlp_lr=cpu(mlp.lr), mlp_dims=kw["mlp_dims"],
                       mlp_feats=kw["mlp_feats"])
        out = soc_kernel.soc_step_episode(*args, **kw)
        want = soc_ref.episode_ref(
            c.static, cpu(c.learned),
            rewards.RewardWeights(*map(cpu, c.weights)), cpu(c.qtable0),
            cpu(c.extrema0),
            soc_ref.StepInputs(*(None if v is None else cpu(v)
                                 for v in c.xs)),
            ddr_attribution=ddr, gated=gated, **mkw)
        wy = torch.stack([v.to(torch.float32) for v in want[-1]], -1)
        same = torch.equal(out[-1].cpu(), wy) and all(
            torch.equal(a.cpu(), r) for a, r in zip(out[:-1], want[:-1]))
        if not same:
            fail(f"coverage T={kw['n_threads']} n_tiles={kw['n_tiles']} "
                 f"S={xf.shape[1]} {ddr=} {gated=} faulted={c.xs.faulted} "
                 f"mlp={kw.get('mlp_dims')}: the kernel is not bitwise "
                 "equal to the plain version")

    t_cov = time.perf_counter()
    n_cov = 0
    for t_, nt_ in ((t_, nt_) for t_ in COVER_T for nt_ in COVER_TILES):
        for faulted, combos in ((False, ((False, False), (True, True))),
                                (True, ((True, False),))):
            c = coverage.coverage_case(t_, nt_, 37, B=3,
                                       seed=t_ * 97 + nt_, faulted=faulted,
                                       device=dev)
            for ddr, gated in combos:
                coverage_vs_plain(c, ddr, gated)
                n_cov += 1
    for s_ in (1, 33, 65):
        for faulted in (False, True):
            coverage_vs_plain(coverage.coverage_case(
                n_thr, n_tiles, s_, B=3, seed=s_, faulted=faulted,
                device=dev), True, True)
            n_cov += 1
    cov_keys = prng.PRNGKey(np.arange(3), device=dev)
    for feats, faulted in ((f, x) for f in ("sense", "onehot")
                           for x in (False, True)):
        cov_mlp = socnn.init_mlp_qstate(cov_keys, socnn.MLPConfig(
            features=feats))
        for t_, nt_, gated in ((n_thr, n_tiles, False), (33, 4, True)):
            coverage_vs_plain(
                coverage.coverage_case(t_, nt_, 45, B=3, seed=t_ + nt_,
                                       faulted=faulted, device=dev),
                gated=gated, mlp=cov_mlp,
                qfun=torch.tensor([True, False, True], device=dev))
            n_cov += 1
    print(f"soc_step_episode coverage: {n_cov} launches (K1, K1f, K1m, K1m "
          f"faulted; T in {COVER_T} x n_tiles in {COVER_TILES}, S 1, 33, "
          f"37, 45, 65) bitwise equal to the plain version on the CPU, "
          f"{time.perf_counter() - t_cov:.1f} s")

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
            if getattr(want, f) is None:      # a table stream's wpack
                if getattr(got, f) is not None:
                    fail(f"{what}: {f} differs")
                continue
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
                    rg_ops.launches, soc_ops.mlp_serve_launches,
                    soc_ops.mlp_fault_serve_launches)

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

    # the episode kernel's arguments at each path's shapes, recorded as the
    # paths launch it, for the times phase: the first launch of each
    # (path, kernel, B, S)
    episode_kernel = soc_kernel.soc_step_episode
    recorded, rec_path = {}, [None]

    def recording_episode(*a, **kw):
        name = ("soc_step_episode"
                + ("_mlp" if len(a) > 5 and a[5] is not None else "")
                + ("_faulted" if kw.get("faulted") else ""))
        recorded.setdefault((rec_path[0], name, *a[0].shape[:2]),
                            (a, dict(kw)))
        return episode_kernel(*a, **kw)

    soc_kernel.soc_step_episode = recording_episode
    rec_path[0] = "fig6"
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
    if counts["fig6"] != launches(soc_step_episode=expected):
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
        vals = [v for p in r.phases for v in (
            p.wall_time, p.offchip_accesses, *(x for rec in p.invocations
                                               for x in (rec.exec_time,
                                                         rec.offchip_true,
                                                         rec.reward)))]
        if not np.isfinite(vals).all():
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
    rec_path[0] = "fig9"
    torch.cuda.synchronize()
    reset_counts()
    t9 = time.perf_counter()
    r9 = fig9.run_port(dev)
    torch.cuda.synchronize()
    fig9_s = time.perf_counter() - t9
    counts["fig9"] = read()
    e9 = r9["_engine"]
    if counts["fig9"] != launches(soc_step_episode=e9["expected_launches"]):
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
    rec_path[0] = "fig11"
    torch.cuda.synchronize()
    reset_counts()
    t11 = time.perf_counter()
    r11 = fig11.run_port(dev)
    torch.cuda.synchronize()
    fig11_s = time.perf_counter() - t11
    counts["fig11"] = read()
    e11 = r11["_engine"]
    want11 = launches(soc_step_episode=e11["expected_episode_launches"],
                      soc_step_serve=e11["expected_serve_launches"])
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
        for f in soc_ref.ServeCarry._fields[:-1]:   # no wpack
            a, r = getattr(kc, f), getattr(rc, f)
            if not torch.allclose(a.float(), r.float(), rtol=TOL, atol=TOL):
                fail(f"{what}: carry {f} differs")
            err = max(err, (a.float() - r.float()).abs().max().item())
        if err != 0.0:
            fail(f"{what}: not bitwise equal to the plain version (max abs "
                 f"err {err})")
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
                    and same_carry(torch, c2, kc)):
                fail(f"{what}: two chained half chunks differ from one")
            print(f"{what}: two chained chunks of {h} requests == one of "
                  f"{n_req}, bitwise")
        return err, ev0.elapsed_time(ev1), ((xf, xi, xv, consts, carry0),
                                            kw)

    sv_err, _, sv_light_packed = serve_vs_plain(0.2, None)
    err, sv_plain_ms, sv_packed = serve_vs_plain(2.0, None)
    sv_err = max(sv_err, err)
    svf_err, _, _ = serve_vs_plain(0.2, storm11)
    err, svf_plain_ms, svf_packed = serve_vs_plain(2.0, storm11)
    svf_err = max(svf_err, err)
    # the edge grid (coverage.serve_edge_case): a full queue under a
    # priority reserve, retries, deadline misses, a watchdog that trips
    # and releases; one launch and three chained ones, bitwise
    for faulted_ in (False, True):
        for seed_ in (3, 4):
            c = coverage.serve_edge_case(seed=seed_, faulted=faulted_,
                                         device=dev)
            rc, ry = soc_ref.serve_episode_ref(
                c.static, c.learned, c.weights, c.sp, c.carry0, c.xs,
                c.t_arr, c.deadline, c.priority)
            n_ = c.t_arr.shape[1]
            for cuts in ((0, n_), (0, n_ // 3, 2 * n_ // 3, n_)):
                carry_, ys_ = c.carry0, []
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    sl = slice(lo, hi)
                    carry_, y_ = soc_ops.fused_serve_episode(
                        c.static, c.learned, c.weights, c.sp, carry_,
                        soc_ref.StepInputs(*(None if v is None else v[:, sl]
                                             for v in c.xs)),
                        c.t_arr[:, sl], c.deadline[:, sl],
                        c.priority[:, sl])
                    ys_.append(y_)
                if not (torch.equal(torch.cat(ys_, 1), ry)
                        and same_carry(torch, carry_, rc)):
                    fail(f"soc_step_serve{'_faulted' if faulted_ else ''} "
                         f"edge grid (seed {seed_}, {len(cuts) - 1} "
                         "launches): not bitwise equal to the plain version")
            col = {nm: i for i, nm in enumerate(soc_ref.SERVE_YCOLS)}
            hist = torch.bincount(ry[1, :, col["retries"]].long(),
                                  minlength=5).tolist()
            print(f"soc_step_serve{'_faulted' if faulted_ else ''} edge grid "
                  f"seed {seed_} ({'; '.join(coverage.SERVE_EDGES)}): "
                  f"bitwise equal in one launch and three chained; served "
                  f"{ry[..., col['executed']].sum(1).int().tolist()} of "
                  f"{n_}, stream 1 retries {hist}, watchdog steps "
                  f"{ry[3, :, col['degraded']].sum().int().item()}")

    # the MLP edge grid (coverage.serve_mlp_edge_case): a learning network,
    # its frozen copy, a table and NON_COH beside placeholders, a +inf
    # Q-value, a watchdog that trips and releases, at the paths' sense
    # network (K2m's register path), the one-hot and the widest networks
    # (shared memory); one launch and three chained ones, bitwise, packs
    # included
    for net_ in coverage.SERVE_MLP_NETS:
        for faulted_ in (False, True):
            mc = coverage.serve_mlp_edge_case(net_, seed=3, faulted=faulted_,
                                              device=dev)
            c = mc.case
            mkw = dict(qfun=mc.qfun, mlp_lr=mc.mlp.lr,
                       mlp_dims=socnn.mlp_dims(mc.mlp.cfg),
                       mlp_feats=mc.mlp.cfg.features)
            rc, ry = soc_ref.serve_episode_ref(
                c.static, c.learned, c.weights, c.sp, c.carry0, c.xs,
                c.t_arr, c.deadline, c.priority, **mkw)
            n_ = c.t_arr.shape[1]
            what = (f"soc_step_serve_mlp{'_faulted' if faulted_ else ''} "
                    f"edge grid ({net_} network {mkw['mlp_dims']})")
            for cuts in ((0, n_), (0, n_ // 3, 2 * n_ // 3, n_)):
                carry_, ys_ = c.carry0, []
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    sl = slice(lo, hi)
                    carry_, y_ = soc_ops.fused_serve_episode(
                        c.static, c.learned, c.weights, c.sp, carry_,
                        soc_ref.StepInputs(*(None if v is None else v[:, sl]
                                             for v in c.xs)),
                        c.t_arr[:, sl], c.deadline[:, sl],
                        c.priority[:, sl], qfun=mc.qfun, mlp=mc.mlp)
                    ys_.append(y_)
                if not (torch.equal(torch.cat(ys_, 1), ry)
                        and same_carry(torch, carry_, rc)):
                    fail(f"{what}, {len(cuts) - 1} launches: not bitwise "
                         "equal to the plain version")
            col = {nm: i for i, nm in enumerate(soc_ref.SERVE_YCOLS)}
            print(f"{what}: {'; '.join(coverage.SERVE_MLP_EDGES)}; "
                  f"{'registers' if soc_kernel.serve_net_in_registers(mkw['mlp_dims']) else 'shared memory'}; "
                  f"bitwise equal in one launch and three chained, packs "
                  f"included; served "
                  f"{ry[..., col['executed']].sum(1).int().tolist()} of "
                  f"{n_}, degraded "
                  f"{ry[..., col['degraded']].sum(1).int().tolist()}")

    # ---- 8. Fig. 10 at full width -----------------------------------------
    rec_path[0] = "fig10"
    torch.cuda.synchronize()
    reset_counts()
    t10 = time.perf_counter()
    r10 = fig10.run_port(dev)
    torch.cuda.synchronize()
    fig10_s = time.perf_counter() - t10
    counts["fig10"] = read()
    e10 = r10["_engine"]
    want10 = launches(
        soc_step_episode=e10["expected_episode_launches"],
        soc_step_episode_faulted=e10["expected_fault_episode_launches"])
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
          + f"), launches {dict(zip(KERNELS, counts['fig10']))}")

    # ---- 8b. Fig. 10's DES cross-check, a path of its own ------------------
    rec_path[0] = "fig10_des_xcheck"
    torch.cuda.synchronize()
    reset_counts()
    t10x = time.perf_counter()
    x10 = fig10.des_crosscheck(dev)
    torch.cuda.synchronize()
    fig10x_s = time.perf_counter() - t10x
    counts["fig10_des_xcheck"] = read()
    want10x = launches(
        soc_step_episode=x10["expected_episode_launches"],
        soc_step_episode_faulted=x10["expected_fault_episode_launches"])
    if counts["fig10_des_xcheck"] != want10x:
        fail(f"Fig. 10's DES cross-check launched "
             f"{dict(zip(KERNELS, counts['fig10_des_xcheck']))}, expected "
             f"{dict(zip(KERNELS, want10x))}")
    print(f"fig10 DES cross-check on {card}: {fig10x_s:.3f} s wall, "
          f"{x10['des_invocations']} DES invocations, launches "
          f"{dict(zip(KERNELS, counts['fig10_des_xcheck']))}; largest "
          f"per-phase gap {x10['max_rel_err']:.3g}, agree {x10['agree']}")
    if not x10["agree"]:
        fail("Fig. 10: the event-driven simulator and the batched "
             "environment disagree under the storms")
    r10["_des_crosscheck"] = x10
    (ROOT / "chiprun_out" / "fig10_port.json").write_text(
        json.dumps(r10, indent=1))

    # ---- 9. storm serving through ServeEnv at full width -------------------
    rec_path[0] = "storm_serving"
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
    if counts["storm_serving"] != launches(soc_step_serve_faulted=1):
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
    storm_json = {f: getattr(st_res, f).tolist() for f in st_res._fields}
    storm_json["qtable"] = st_qs.qtable.tolist()
    (ROOT / "chiprun_out" / "storm_serving_port.json").write_text(
        json.dumps(storm_json))
    if parent_kernel is not None:
        # Fig. 11 and storm serving again through the parent commit's SoC
        # kernels: a redesign must not move a result
        from benchmarks.torch_same_results import differences
        this_soc = soc_ops._kernel
        soc_ops._kernel = parent_kernel
        try:
            r11p = fig11.run_port(dev)
            _, pst_qs, pst_res = vec.ServeEnv(
                env1, queue_cap=fig11.QUEUE_CAP,
                n_requests=n_req).serve_specs(
                app1, specs1, fig11._traffic(
                    traffic, cap["capacity_per_mcycle"] * 1e-6,
                    fig11.QUEUE_CAP * svc, 0.25 * svc), cfg=cfg1,
                faults=storm11)
        finally:
            soc_ops._kernel = this_soc
        storm_p = {f: getattr(pst_res, f).tolist() for f in pst_res._fields}
        storm_p["qtable"] = pst_qs.qtable.tolist()
        for what, a, b_, name in (
                ("Fig. 11", r11, r11p, "fig11"),
                ("storm serving", storm_json, storm_p, "storm_serving")):
            (ROOT / "chiprun_out" / f"{name}_parent_kernels.json").write_text(
                json.dumps(b_))
            diff = differences(json.loads(json.dumps(a)),
                               json.loads(json.dumps(b_)))
            if diff:
                fail(f"{what} through the parent's SoC kernels differs: "
                     f"{diff[:3]}")
            print(f"{what} through the parent's SoC kernels: every result "
                  "equal (benchmarks/torch_same_results.py, _engine left "
                  "out)")

    # ---- 9b. Fig. 13 at full width -----------------------------------------
    rec_path[0] = "fig13"
    torch.cuda.synchronize()
    reset_counts()
    t13 = time.perf_counter()
    r13, agents13 = fig13.run_port(dev, keep_agents=True)
    torch.cuda.synchronize()
    fig13_s = time.perf_counter() - t13
    counts["fig13"] = read()
    e13 = r13["_engine"]
    want13 = launches(
        soc_step_episode=e13["expected_episode_launches"],
        soc_step_episode_mlp=e13["expected_mlp_episode_launches"])
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
    soc_kernel.soc_step_episode = episode_kernel

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
                keys, sq, skv, h, **{n: x for n, x in feat.items()
                                     if n != "softcap"}))
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
    qwen_bf16 = dict(prefill_s=q_out["prefill_s"],
                     decode_ms=q_out["decode_s"] / QWEN_GEN * 1e3,
                     tok_s=q_out["decode_tok_per_s"])
    counts["qwen3_serve"] = read()
    check_bodies("qwen3_serve", qcfg.n_layers, qcfg.n_layers * QWEN_GEN)
    want_q = launches(flash_attention=qcfg.n_layers * (1 + QWEN_GEN))
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
    qwen_bf16["peak_gib"] = q_mem / 2**30
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
    # the coverage probe: logw = 0 and small integer r, k, v, u and s0, so
    # every sum is exact and the kernel must equal the plain version
    # bitwise, at every head dim, over one to 128 chunks
    rw_probes = 0
    for kd_, t_, state_ in rw_cov.probe_cases():
        args = rw_cov.probe_inputs(2, 3, t_, kd_, state=state_, device=dev)
        got = rw_kernel.rwkv6_scan(*args)
        want = rw_ref.wkv_ref(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            fail(f"rwkv6_scan coverage probe K={kd_} T={t_} "
                 f"{'random' if state_ else 'zero'} state: not bitwise "
                 f"equal to the plain version (max abs err {err})")
        rw_probes += 1
    print(f"rwkv6_scan coverage probe: {rw_probes} cases (K in "
          f"{rw_cov.HEAD_DIMS}, T in {rw_cov.PROBE_T}, zero and "
          "random-integer states) bitwise equal to the plain version")

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
    want_r = launches(rwkv6_scan=rcfg.n_layers)
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
    # in float32 at 2e-5 and bf16 at the reference's tolerance, each
    # through the body its plan names; the coverage probe at the path's
    # shapes ----------------------------------------------------------------
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

    def bf16_ulps(got, want):
        """The largest |got - want| of an output row in units of the bf16
        spacing at the row's largest |want| (rows of zeros left out): an
        element near 0, where the float32 sums' order shows, is measured
        at its row's scale."""
        want = want.float()
        err = (got.float() - want).abs().amax(-1)
        scale = want.abs().amax(-1)
        ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
        nz = scale > 0
        return (err[nz] / ulp[nz]).max().item() if bool(nz.any()) else 0.0

    gmm_errs, gmm_ulps = {}, {}

    def gmm_check(what, x, w, sizes, body):
        """K4 against ``ref.gmm_ref`` on the same inputs through ``body``
        (its plan's), bitwise equal to a second launch, rows past each
        group's size exactly 0; returns the max abs error."""
        tol = (GMM_BF16_TOL if x.dtype == torch.bfloat16
               else dict(rtol=TOL, atol=TOL))
        got, plan = gmm_kernel.launch(x, w, sizes)
        again = gmm_kernel.moe_gmm(x, w, sizes)
        torch.cuda.synchronize()
        if plan.body != body:
            fail(f"moe_gmm {what} took {plan.body}, not {body}")
        if not torch.equal(got, again):
            fail(f"moe_gmm {what}: two launches differ")
        want = gmm_ref.gmm_ref(x, w, sizes)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != x.dtype or not torch.allclose(
                got.float(), want.float(), **tol):
            fail(f"moe_gmm vs plain {what}: max abs err {err}")
        past = torch.arange(x.shape[-2], device=dev) >= sizes[..., None]
        if not bool((got[past] == 0).all()):
            fail(f"moe_gmm {what}: a row past its group's size is not 0")
        key = f"{plan.body} {str(x.dtype).split('.')[-1]}"
        gmm_errs[key] = max(gmm_errs.get(key, 0.0), err)
        ulps = ""
        if x.dtype == torch.bfloat16:
            u = bf16_ulps(got, want)
            gmm_ulps[plan.body] = max(gmm_ulps.get(plan.body, 0.0), u)
            ulps = f", {u:.2f} bf16 ulps at its row's scale"
        print(f"moe_gmm vs plain {what} ({plan.body}"
              f"{f', {plan.splits} D slices' if plan.splits > 1 else ''}): "
              f"max abs err {err:.3e}{ulps} (rtol {tol['rtol']}, atol "
              f"{tol['atol']}), rows past each size 0, a second launch "
              f"bitwise equal")
        return err

    gmm_down_dec = GMM_DECODE[:3] + GMM_DECODE[3:][::-1]
    for dt in (torch.float32, torch.bfloat16):
        bf = dt == torch.bfloat16
        for what, (b_, e, c, d, f), hi, body in (
                ("prefill gate/up", GMM_PREFILL, GMM_PREFILL[2], "tc_gmm"),
                ("prefill down", GMM_DOWN, GMM_DOWN[2], "tc_gmm"),
                ("decode gate/up", GMM_DECODE, 1, "gemv_decode"),
                ("decode down", gmm_down_dec, 1, "gemv_decode")):
            gmm_check(f"{what} {(b_, e, c, d, f)} {dt}",
                      *gmm_inputs((b_,), e, c, d, f, dt, hi, GMM_REAL),
                      body if bf else "fp32_tiled")
        for shape in GMM_SHAPES:
            gmm_check(f"{shape} {dt}", *gmm_inputs((), *shape, dt, shape[1]),
                      "tc_gmm" if bf else "fp32_tiled")
    print(f"moe_gmm: largest bf16 error by body, in bf16 ulps at the "
          f"output row's largest value: {gmm_ulps} (the reference's bound: "
          f"rtol 5e-2, atol 5e-1)")

    # the coverage probe (ref.probe_inputs: one or two 1s a row of x, small
    # integer weights, sizes through the tile edges) exact at the path's
    # shapes through the bodies the path takes
    gmm_probes = []
    for what, (b_, e, c, d, f), body in (
            ("prefill gate/up", GMM_PREFILL, "tc_gmm"),
            ("prefill down", GMM_DOWN, "tc_gmm"),
            ("decode gate/up", GMM_DECODE, "gemv_decode"),
            ("decode down", gmm_down_dec, "gemv_decode")):
        x, w, sizes = gmm_ref.probe_inputs((b_,), e, c, d, f,
                                           torch.bfloat16, dev)
        out, plan = gmm_kernel.launch(x, w, sizes)
        bad = int((out.float() != gmm_ref.probe_expected(
            (b_,), e, c, d, f, dev)).sum())
        if plan.body != body or bad:
            fail(f"moe_gmm coverage probe {what}: {bad} wrong outputs "
                 f"({plan.body}, not {body})")
        gmm_probes.append(f"{what} {(b_, e, c, d, f)}")
        print(f"moe_gmm coverage probe {what} {(b_, e, c, d, f)} ({body}): "
              f"exact, sizes {sorted(set(sizes.flatten().tolist()))}")
        del x, w, out

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
    gmm_bodies = dict(gmm_ops.body_launches)
    want_gmm = {"tc_gmm": 3 * gcfg.n_layers,
                "gemv_decode": 3 * gcfg.n_layers * QWEN_GEN,
                "fp32_tiled": 0}
    if gmm_bodies != want_gmm:
        fail(f"granite_serve: K4 bodies {gmm_bodies}, expected {want_gmm}")
    print(f"granite_serve: K4 launches by body {gmm_bodies}")
    steps_g = gcfg.n_layers * (1 + QWEN_GEN)
    want_g = launches(flash_attention=steps_g, moe_gmm=3 * steps_g)
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
    want_c = launches(
        flash_attention=kinds.count("attn_local") * (1 + QWEN_GEN),
        rglru_scan=kinds.count("rg"))
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

    # ---- 9p. the event-driven simulator (DES): card == CPU, the fidelity
    # contract against the batched environment, Fig. 2, 3 and 5 --fidelity
    # (in a function, so its names leave the later phases' alone)
    def chain_app(soc_, seed, n_threads=1):
        """tests/test_vecenv_equivalence.py's app: 3 phases of
        ``n_threads`` serial 3-invocation chains looped twice."""
        rng = np.random.default_rng(seed)
        phases = [apps.make_phase(rng, soc_, name=f"p{i}",
                                  n_threads=n_threads, size_classes=[c],
                                  chain_len=3, loops=2)
                  for i, c in enumerate(("S", "M", "L"))]
        return des.Application(name=f"{soc_.name}-chain{n_threads}",
                               phases=phases)

    def des_phase():
        rec_path[0] = "des"
        des_int = ("acc_id", "mode", "state_idx")
        des_float = ("start", "end", "exec_time", "offchip_true",
                     "offchip_attr", "reward")

        def mlp_agent(device):
            """A frozen sense network, its weights perturbed from a seed so its
            Q-rows are not all ties (made on the CPU, copied to ``device``)."""
            m = socnn.init_mlp_qstate(prng.PRNGKey(3))
            w = m.wpack + 0.3 * prng.normal(prng.PRNGKey(4), tuple(
                m.wpack.shape[1:]))
            m = socnn.freeze(m._replace(wpack=w))
            return socnn.MLPQPolicy(socnn.MLPQState(
                *(v.to(device) for v in m[:4]), cfg=m.cfg))

        def des_runs(device):
            """The families on the two chain apps: (records by run, walls,
            invocations)."""
            out, t_d, n_d = {}, 0.0, 0
            for soc_ in (SOC_MOTIV_ISO, SOCS["SoC1"]):
                sim = des.SoCSimulator(soc_, device=device)
                app = chain_app(soc_, 3)
                t_a = time.perf_counter()
                agent, _ = orch.train_cohmeleon(sim, iterations=2, seed=0,
                                                n_phases=2)
                runs = [(p.name, p) for p in pol.all_fixed_policies()] + [
                    ("manual", pol.ManualPolicy()),
                    ("random", pol.RandomPolicy()),
                    ("cohmeleon", agent), ("mlp", mlp_agent(device))]
                for name, p in runs:
                    out[f"{soc_.name}/{name}"] = sim.run(app, p, seed=7,
                                                         train=False)
                out[f"{soc_.name}/storm-manual"] = sim.run(
                    app, pol.ManualPolicy(), seed=7, train=False,
                    faults=faults.storm(18, 1.0, prng.PRNGKey(42),
                                        device=device))
                out[f"{soc_.name}/qtable"] = agent.qs.qtable.cpu()
                t_d += time.perf_counter() - t_a
                n_d += sim.invocations
            return out, t_d, n_d

        torch.cuda.synchronize()
        reset_counts()
        g_des, g_t, g_n = des_runs(dev)
        c_des, c_t, c_n = des_runs("cpu")
        if any(read()):
            fail(f"the DES runs launched {dict(zip(KERNELS, read()))}")
        rec_f = lambda run: np.asarray(
            [[getattr(r, f) for f in des_float] for r in run])
        phase_f = lambda run: np.asarray(
            [[p.wall_time, p.offchip_accesses] for p in run.phases])
        n_bitwise = n_float = 0
        for key, g in g_des.items():
            c = c_des[key]
            if key.endswith("/qtable"):
                if not torch.allclose(g, c, rtol=TOL, atol=TOL):
                    fail(f"DES {key}: card and CPU differ")
                n_float += g.numel()
                n_bitwise += int((g == c).sum())
                continue
            gr = [r for p in g.phases for r in p.invocations]
            cr = [r for p in c.phases for r in p.invocations]
            if [[getattr(r, f) for f in des_int] for r in gr] != [
                    [getattr(r, f) for f in des_int] for r in cr]:
                fail(f"DES {key}: card and CPU integer traces differ")
            for gv, cv in ((rec_f(gr), rec_f(cr)), (phase_f(g), phase_f(c))):
                if not np.allclose(gv, cv, rtol=TOL, atol=TOL):
                    fail(f"DES {key}: card and CPU floats differ beyond "
                         f"{TOL}")
                n_float += gv.size
                n_bitwise += int((gv == cv).sum())
        modes_seen = {r.mode for k, g in g_des.items() if not k.endswith(
            "qtable") for p in g.phases for r in p.invocations}
        print(f"DES card == CPU on two chain apps (SoC-motiv-iso, SoC1): four "
              f"fixed, manual, random, a Q agent trained 2 iterations, a "
              f"frozen MLP agent, manual under storm(18, 1.0): integer "
              f"traces equal, {n_bitwise}/{n_float} floats bitwise, the rest within {TOL}; "
              f"modes seen {sorted(modes_seen)}; card {g_n} invocations in "
              f"{g_t:.3f} s ({g_n / g_t:.1f}/s), CPU {c_n} in {c_t:.3f} s "
              f"({c_n / c_t:.1f}/s)")

        # the timing model's CUDA graphs against its eager ops on the card:
        # random 32-slot concurrent sets (k active), healthy and faulted
        g_rng = np.random.default_rng(21)
        n_graph = 0
        for soc_ in (SOC_MOTIV_PAR, SOCS["SoC1"]):
            sim = des.SoCSimulator(soc_, device=dev)
            nt = soc_.n_mem_tiles
            for _ in range(64):
                k = int(g_rng.integers(0, des.MAX_SLOTS + 1))
                slots = np.zeros((des.MAX_SLOTS, 3 + nt), np.float32)
                slots[:, 0] = -1.0
                slots[:k, 0] = g_rng.integers(0, 4, k)
                slots[:k, 1] = g_rng.integers(0, soc_.n_accs, k)
                slots[:k, 2] = np.exp(g_rng.uniform(11, 23, k) * np.log(2.0))
                slots[:k, 3:] = g_rng.random((k, nt)) < 0.6
                packed = np.concatenate([
                    np.asarray([g_rng.integers(0, 4), g_rng.integers(
                        0, soc_.n_accs), 2.0 ** g_rng.uniform(11, 23),
                        g_rng.random()], np.float32),
                    (g_rng.random(nt) < 0.6).astype(np.float32),
                    slots.reshape(-1)])
                fr = faults.StepFault(*(torch.tensor(
                    [v], dtype=torch.float32, device=dev) for v in (
                        1 + 4 * g_rng.random(), 1 / (1 + 3 * g_rng.random()),
                        4 * g_rng.random(), 5000.0 * g_rng.integers(0, 4))))
                for f in (None, fr):
                    got = sim.perf_fn(packed, f)
                    want = sim.perf_fn.eager(torch.from_numpy(packed).to(dev),
                                             f).cpu().numpy()
                    if not np.array_equal(got, want):
                        fail(f"DES timing model {soc_.name}: the CUDA graph "
                             f"{got} differs from its eager ops {want}")
                    n_graph += 1
        print(f"DES timing model: the CUDA graphs (healthy, faulted) bitwise "
              f"equal to their eager ops on {n_graph} concurrent sets")

        # the fidelity contract (tests/test_vecenv_equivalence.py) on the card
        reset_counts()
        t_fv = time.perf_counter()
        worst_t = worst_cmp = 0.0
        for soc_ in (SOC_MOTIV_ISO, SOCS["SoC1"]):
            sim = des.SoCSimulator(soc_, device=dev)
            env_d = vec.VecEnv.from_simulator(sim)
            app = chain_app(soc_, 3)
            comp = vec.compile_app(app, soc_, seed=7)
            for m in CoherenceMode:
                d = sim.run(app, pol.FixedHomogeneous(m), seed=7, train=False)
                _, r = env_d.episode(comp, policy="fixed", fixed_modes=int(m))
                dt = np.array([p.wall_time for p in d.phases])
                do = np.array([p.offchip_accesses for p in d.phases])
                rt = r.phase_time.cpu().numpy()
                if not (np.allclose(rt, dt, rtol=1e-4, atol=0) and np.allclose(
                        r.phase_offchip.cpu().numpy(), do, rtol=1e-4,
                        atol=1e-3)):
                    fail(f"DES vs vecenv {soc_.name} {m.name}: phase metrics")
                worst_t = max(worst_t, float(np.max(np.abs(rt - dt) / dt)))
                if m == CoherenceMode.COH_DMA and (
                        [x.state_idx for p in d.phases for x in p.invocations]
                        != r.state_idx.tolist()):
                    fail(f"DES vs vecenv {soc_.name}: sensed states differ")
            d = sim.run(app, pol.ManualPolicy(), seed=7, train=False)
            _, r = env_d.episode(comp, policy="manual")
            if [x.mode for p in d.phases for x in p.invocations] != \
                    r.mode.tolist():
                fail(f"DES vs vecenv {soc_.name}: manual modes differ")
            suite_d = pol.all_fixed_policies() + [pol.ManualPolicy()]
            cd = orch.compare_policies(sim, app, suite_d, seed=7,
                                       backend="des")
            cv = orch.compare_policies(sim, app, suite_d, seed=7,
                                       backend="vecenv")
            for name in cd.policies:
                for a, b in zip(cd.geomean(name), cv.geomean(name)):
                    worst_cmp = max(worst_cmp, abs(b - a) / max(a, 1e-9))
                    if abs(b - a) > 1e-3 * max(a, 1e-9) + 1e-6:
                        fail(f"compare_policies backends differ on {name}")
        sim = des.SoCSimulator(SOC_MOTIV_PAR, device=dev)
        env_d = vec.VecEnv.from_simulator(sim)
        app = chain_app(SOC_MOTIV_PAR, 5, n_threads=2)
        comp = vec.compile_app(app, SOC_MOTIV_PAR, seed=7)
        d = sim.run(app, pol.FixedHomogeneous(CoherenceMode.NON_COH_DMA),
                    seed=7, train=False)
        _, r = env_d.episode(comp, policy="fixed", fixed_modes=0)
        if not np.allclose(r.phase_offchip.cpu().numpy(),
                           [p.offchip_accesses for p in d.phases], rtol=1e-4):
            fail("DES vs vecenv: NON_COH off-chip counts differ on two "
                 "threads")
        torch.cuda.synchronize()
        counts["des_vs_vecenv"] = read()
        des_vs_vec_s = time.perf_counter() - t_fv
        print(f"DES vs vecenv on {card}: modes and states equal on the chain "
              f"apps, largest phase-time gap {worst_t:.3g} (bound 1e-4), "
              f"compare_policies backends within {worst_cmp:.3g} (bound "
              f"1e-3), "
              f"NON_COH off-chip equal on two threads; {des_vs_vec_s:.3f} s, "
              f"launches {dict(zip(KERNELS, counts['des_vs_vecenv']))}")

        # Fig. 2, Fig. 3 and Fig. 5 --fidelity at full width, each a path
        def des_numbers(x):
            if isinstance(x, dict):
                x = list(x.values())
            if isinstance(x, (list, tuple)):
                return [v for item in x for v in des_numbers(item)]
            return ([float(x)] if isinstance(x, (int, float))
                    and not isinstance(x, bool) else [])

        des_paths = {}
        for key, run in (("fig2_des", lambda: fig2.run_port(dev)),
                         ("fig3_des", lambda: fig3.run_port(dev)),
                         ("fig5_des",
                          lambda: fig5.run_port(dev, fidelity=True))):
            torch.cuda.synchronize()
            reset_counts()
            t_p = time.perf_counter()
            rep = run()
            torch.cuda.synchronize()
            des_paths[key] = time.perf_counter() - t_p
            counts[key] = read()
            if any(counts[key]):
                fail(f"{key} launched {dict(zip(KERNELS, counts[key]))}; the "
                     f"DES path launches none")
            e = rep["_engine"]
            if not all(math.isfinite(v) for v in des_numbers(
                    {k: v for k, v in rep.items() if k != "_engine"})):
                fail(f"{key}: non-finite results")
            print(f"{key} on {card}: {des_paths[key]:.3f} s wall, "
                  f"{e['invocations']} invocations, "
                  f"{e['invocations_per_s']:.1f} a second; headline "
                  f"{json.dumps(rep['_headline'])}")
            out_json = ROOT / "chiprun_out" / f"{key.split('_')[0]}_port.json"
            out_json.write_text(json.dumps(rep, indent=1))
        t_c = time.perf_counter()
        r3c = fig3.run_port("cpu")
        print(f"fig3_des on the CPU of the same machine: "
              f"{time.perf_counter() - t_c:.3f} s wall, "
              f"{r3c['_engine']['invocations_per_s']:.1f} invocations a "
              f"second; "
              f"headline {json.dumps(r3c['_headline'])}")
        return des_paths, des_vs_vec_s

    des_paths, des_vs_vec_s = des_phase()

    # ---- 9q. the DES serving mirror card == CPU, a forced one-card shard
    # split, a small Fig. 12 sweep card == CPU, the unfused step against
    # K1; then Fig. 12 and Fig. 11's DES cross-check at full width
    def soc_layer_phase():
        rec_path[0] = "soc_layer"
        from benchmarks import torch_fig12_dse as fig12
        from repro_torch.soc import shard

        # DES serve: the same arrival table on the card and the CPU
        n_req = 64
        serve_int = ("executed", "retries", "depth", "degraded", "mode",
                     "state_idx", "acc_id", "tenant")
        serve_float = ("start", "finish", "exec_time", "latency", "reward")
        reset_counts()
        n_float = n_bitwise = 0
        t_s = time.perf_counter()
        for soc_ in (SOC_MOTIV_ISO, SOCS["SoC1"]):
            comp = vec.compile_app(chain_app(soc_, 0), soc_, seed=7)
            probe = des.SoCSimulator(soc_, device="cpu").serve(
                comp.schedule, pol.FixedHomogeneous(0), traffic.
                sample_arrivals(traffic.poisson(1e-9, seed=3), 32,
                                comp.n_steps), queue_cap=4)
            me = float(np.mean([r["exec_time"] for r in probe]))
            tspec = traffic.poisson(1.5 * soc_.n_accs / me,
                                    deadline=12 * me, backoff=0.5 * me,
                                    seed=11)
            arr = traffic.sample_arrivals(tspec, n_req, comp.n_steps)

            def serve_runs(device):
                sim = des.SoCSimulator(soc_, device=device)
                runs = [(f"fixed{m}", pol.FixedHomogeneous(m), False, None)
                        for m in range(4)]
                runs += [("manual", pol.ManualPolicy(), False, None),
                         ("q", pol.QPolicy(qlearn.QConfig(decay_steps=n_req),
                                           seed=5, device=device), True,
                          None),
                         ("storm-nc", pol.FixedHomogeneous(0), False,
                          faults.storm(n_req, 0.7, prng.PRNGKey(42),
                                       device=device))]
                return {name: sim.serve(comp.schedule, p, arr, queue_cap=4,
                                        backoff=0.5 * me, train=train,
                                        faults=f, seed=7)
                        for name, p, train, f in runs}

            g_runs, c_runs = serve_runs(dev), serve_runs("cpu")
            for name, g in g_runs.items():
                c = c_runs[name]
                if [[r[f] for f in serve_int] for r in g] != [
                        [r[f] for f in serve_int] for r in c]:
                    fail(f"DES serve {soc_.name} {name}: card and CPU "
                         f"integer fields differ")
                gv = np.asarray([[r[f] for f in serve_float] for r in g])
                cv = np.asarray([[r[f] for f in serve_float] for r in c])
                if not np.allclose(gv, cv, rtol=TOL, atol=TOL):
                    fail(f"DES serve {soc_.name} {name}: card and CPU "
                         f"floats differ beyond {TOL}")
                n_float += gv.size
                n_bitwise += int((gv == cv).sum())
        if any(read()):
            fail(f"the DES serve launched {dict(zip(KERNELS, read()))}")
        print(f"DES serve card == CPU on two chain apps (SoC-motiv-iso, "
              f"SoC1; {n_req} requests at 1.5x, queue_cap 4): four fixed, "
              f"manual, a Q agent learning, NON_COH under storm(64, 0.7): "
              f"integer fields equal, {n_bitwise}/{n_float} floats bitwise, "
              f"the rest within {TOL}; {time.perf_counter() - t_s:.3f} s")

        # a forced split of the stacked trainer and episodes in two chunks
        # on the one card: bitwise one call, twice the launches
        socs2 = [SOCS["SoC1"], SOCS["SoC2"]]
        st_env = StackedVecEnv(socs2, seed=1, device=dev)
        apps2 = [apps.make_application(s, seed=7, n_phases=2) for s in socs2]
        st_iters = [st_env.compile(apps2, seed=it) for it in range(2)]
        st_cfg = qlearn.QConfig(decay_steps=torch.tensor(
            [2 * s for s in st_iters[0].n_steps], dtype=torch.int32))
        st_keys = prng.PRNGKey(np.arange(4), device=dev).reshape(2, 2, 2)
        st_w = rewards.stack_weights(WEIGHTS[:2])
        suite6 = ([pol.FixedHomogeneous(m) for m in CoherenceMode]
                  + [pol.RandomPolicy(), pol.ManualPolicy()])
        specs6 = st_env.lower(st_iters[0], suite6)
        shard_launches = {}
        for tag, kw in (("plain", None),
                        ("split", dict(devices=[dev, dev], force=True))):
            torch.cuda.synchronize()
            reset_counts()
            if kw is None:
                q_s, _ = st_env.train_batched(st_iters, st_cfg, st_w,
                                              st_keys)
                e_s = st_env.episodes(st_iters[0], specs6)
            else:
                q_s, _ = shard.sharded_train_batched_stacked(
                    st_env, st_iters, st_cfg, st_w, st_keys, **kw)
                e_s = shard.sharded_episodes(st_env, st_iters[0], specs6,
                                             **kw)
            torch.cuda.synchronize()
            shard_launches[tag] = (read()[0], (q_s, e_s))
        (n_plain, (q_p, e_p)), (n_split, (q_x, e_x)) = (
            shard_launches["plain"], shard_launches["split"])
        if not all(torch.equal(a, b) for a, b in zip((*q_p, *e_p),
                                                    (*q_x, *e_x))):
            fail("forced shard split: results differ from one call")
        if n_split != 2 * n_plain:
            fail(f"forced shard split launched K1 {n_split} times, "
                 f"expected 2 x {n_plain}")
        print(f"soc.shard forced split over [cuda:0, cuda:0] "
              f"(sharded_train_batched_stacked, 2 lanes x 2 agents, 2 "
              f"iterations; sharded_episodes, 6 policies): bitwise one "
              f"call, K1 launches {n_split} vs {n_plain}")

        # a small Fig. 12 sweep, the card against the CPU, bitwise
        small12 = dict(iters=2, n_phases=2, max_buckets=3, min_gain=0.0)
        sw_g = dse.run_sweep(dse.sample_socs(11, 6), device=dev, **small12)
        sw_c = dse.run_sweep(dse.sample_socs(11, 6), device="cpu",
                             **small12)
        if sw_g["groups"] != sw_c["groups"] or not (
                np.array_equal(sw_g["norm_time"], sw_c["norm_time"])
                and np.array_equal(sw_g["norm_mem"], sw_c["norm_mem"])):
            fail("small Fig. 12 sweep: card and CPU differ")
        print(f"small Fig. 12 sweep (6 SoCs, 2 iterations, 2 phases, "
              f"buckets {[len(g) for g in sw_g['groups']]}): card == CPU "
              f"bitwise ({sw_g['norm_time'].size} x 2 metrics)")

        # the unfused plain step on the card against K1, bitwise
        app3 = vec.compile_app(chain_app(SOC_MOTIV_PAR, 6, n_threads=3),
                               SOC_MOTIV_PAR, seed=7)
        env_f = vec.VecEnv(SOC_MOTIV_PAR, seed=0, device=dev)
        env_u = vec.VecEnv(SOC_MOTIV_PAR, seed=0, fused_step=False,
                           device=dev)
        for p in ("q", "fixed", "manual"):
            reset_counts()
            a = env_f.episode(app3, policy=p, key=prng.PRNGKey(3))
            n_fused = read()[0]
            b = env_u.episode(app3, policy=p, key=prng.PRNGKey(3))
            if read()[0] != n_fused or n_fused != 1:
                fail(f"unfused {p}: launched K1 ({read()[0]} after "
                     f"{n_fused})")
            if not all(torch.equal(x, y) for x, y in zip((*a[0], *a[1]),
                                                        (*b[0], *b[1]))):
                fail(f"unfused step on the card: {p} differs from K1")
        print("unfused plain step on the card == K1 bitwise (3-thread chain "
              "app on SoC-motiv-par; q, fixed, manual), no launch")

        # Fig. 12 at full width; each (B, S) launch's first inputs and
        # outputs are kept to hold against the plain version after it
        new_paths = {}
        rec_path[0] = "fig12"
        soc_kernel.soc_step_episode = recording_episode
        fused_episode = soc_ops.fused_episode
        seen12 = {}

        def keeping_episode(*a, **kw):
            out = fused_episode(*a, **kw)
            seen12.setdefault(tuple(a[3].shape[:1]) + tuple(
                a[5].acc_id.shape[1:2]), (a, kw, out))
            return out

        soc_ops.fused_episode = keeping_episode
        torch.cuda.synchronize()
        reset_counts()
        t12 = time.perf_counter()
        try:
            r12 = fig12.run_port(dev)
            torch.cuda.synchronize()
        finally:
            soc_ops.fused_episode = fused_episode
        new_paths["fig12"] = time.perf_counter() - t12
        soc_kernel.soc_step_episode = episode_kernel
        counts["fig12"] = read()
        # the largest bucket's training (108 lanes) and evaluation (108 x 7
        # episodes) launches of the path against ref.episode_ref on their
        # own inputs: the path's outputs, and a second launch's, bitwise
        for pick_b in (lambda bs: max(x for x in bs if x < 200), max):
            b12 = pick_b(k[0] for k in seen12)
            s12 = max(k[1] for k in seen12 if k[0] == b12)
            a, kw, out = seen12[(b12, s12)]
            if kw.get("mlp") is not None:
                fail("Fig. 12 launched an MLP episode")
            again = fused_episode(*a, **kw)
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
            want = soc_ref.episode_ref(
                *a, ddr_attribution=kw.get("ddr_attribution", False),
                gated=kw.get("gated", False))
            ev1.record()
            torch.cuda.synchronize()
            flat = lambda r: [r[0], *r[-1]]
            for label, got in (("path", out), ("second launch", again)):
                if not all(x.shape == y.shape and torch.equal(
                        x.double(), y.double()) for x, y in zip(
                            flat(got), flat(want))):
                    fail(f"Fig. 12 B={b12} S={s12}: the {label}'s K1 "
                         "outputs are not bitwise the plain version's")
            print(f"fig12 K1 launch B={b12} S={s12} (gated, "
                  f"{len(flat(want))} outputs): the path's and a second "
                  f"launch's outputs bitwise equal to ref.episode_ref on "
                  f"the same inputs; plain version "
                  f"{ev0.elapsed_time(ev1):.1f} ms on the card")
        del seen12
        e12 = r12["_engine"]
        want12 = launches(soc_step_episode=e12["expected_episode_launches"])
        if counts["fig12"] != want12 or want12[0] != 16:
            fail(f"Fig. 12 launched {dict(zip(KERNELS, counts['fig12']))}, "
                 f"expected 16 of {KERNELS[0]} only")
        if not all(math.isfinite(v) for row in r12["per_soc"]
                   for v in (*row["cohmeleon"], *row["manual"],
                             *row["fixed_mean"], *row["best_fixed"])):
            fail("Fig. 12: non-finite per-SoC metrics")
        print(f"fig12 headline: {json.dumps(r12['_headline'])}")
        print(f"fig12 path on {card}: {new_paths['fig12']:.3f} s wall "
              f"({e12['n_socs']} SoCs in buckets {e12['bucket_sizes']}; "
              f"compile {e12['compile_s']:.3f} s, train "
              f"{e12['train_s']:.3f} s, lower {e12['lower_s']:.3f} s, "
              f"evaluate {e12['eval_s']:.3f} s; "
              f"{r12['waste']['real_invocations']} real invocations, "
              f"{r12['waste']['padded_volume_bucketed']} padded steps), "
              f"launches {dict(zip(KERNELS, counts['fig12']))}")
        (ROOT / "chiprun_out" / "fig12_port.json").write_text(
            json.dumps(r12, indent=1))

        # Fig. 11's DES cross-check at full width (--fidelity)
        rec_path[0] = "fig11_des_xcheck"
        torch.cuda.synchronize()
        reset_counts()
        t_x = time.perf_counter()
        x11 = fig11.des_crosscheck(dev, fidelity=True)
        torch.cuda.synchronize()
        new_paths["fig11_des_xcheck"] = time.perf_counter() - t_x
        counts["fig11_des_xcheck"] = read()
        ex = x11["_engine"]
        want_x = launches(soc_step_serve=ex["expected_serve_launches"])
        if counts["fig11_des_xcheck"] != want_x or want_x[1] != 13:
            fail(f"Fig. 11's DES cross-check launched "
                 f"{dict(zip(KERNELS, counts['fig11_des_xcheck']))}, "
                 f"expected 13 of {KERNELS[1]} only")
        if not (x11["agree"] and x11["admission_mismatches"] == 0
                and x11["max_err_vs_tolerance"] <= 1.0
                and x11["requests_checked"] == 6144):
            fail(f"Fig. 11's DES cross-check disagrees: {x11}")
        fig11.print_crosscheck("fig11_des_xcheck", x11)
        print(f"fig11_des_xcheck path on {card}: "
              f"{new_paths['fig11_des_xcheck']:.3f} s wall, launches "
              f"{dict(zip(KERNELS, counts['fig11_des_xcheck']))}")
        (ROOT / "chiprun_out" / "fig11_des_xcheck_port.json").write_text(
            json.dumps(x11, indent=1))
        return new_paths

    soc_layer_paths = soc_layer_phase()

    # ---- 9r. MLP-agent serving at Fig. 11's shape: K2m and K2m-faulted
    # on the path, each launch bitwise against the plain version, card ==
    # CPU on a small stream, a killed and resumed checkpointed stream -----
    serve_kernel = soc_kernel.soc_step_serve
    serve_ops = soc_ops.fused_serve_episode

    def mlp_serving_phase():
        """Fig. 11's SoC1 and application: a Q-table trained as Fig. 11
        trains it (K1) and a (14, 16, 16, 4) sense network (Fig. 13's
        MLPConfig) trained through K1m for as many iterations; then four
        policies in one batch, the learning network, its frozen copy, the
        Q-table and fixed NON_COH (the last two with placeholder
        networks; ``fig11.mlp_serving_policies``, which the phase split
        of ``benchmarks/torch_soc_step_phases.py`` builds its launch
        with too), serve 1,024 requests at Fig. 11's five offered loads
        (5 K2m launches) and under storm(1024, 0.7, PRNGKey(42)) at its
        capacity (1 K2m-faulted).  Returns (path seconds, the launches'
        recorded kernel arguments by label)."""
        calls, packed = [], {}

        def rec_ops(*a, **kw):
            out = serve_ops(*a, **kw)
            if kw.get("mlp") is not None:
                calls.append((a, kw, out))
            return out

        def rec_kernel(*a, **kw):
            if a[4].wpack is not None:
                packed.setdefault(("faulted" if kw.get("faulted") else "")
                                  + str(len(calls)), (a, dict(kw)))
            return serve_kernel(*a, **kw)

        soc_ops.fused_serve_episode = rec_ops
        soc_kernel.soc_step_serve = rec_kernel
        rec_path[0] = "mlp_serving"
        torch.cuda.synchronize()
        reset_counts()
        t_m = time.perf_counter()
        iters = fig11.ITERS
        net, mspecs, cfg_s = fig11.mlp_serving_policies(env1, app1, n_req)
        senv = vec.ServeEnv(env1, queue_cap=fig11.QUEUE_CAP,
                            n_requests=n_req)
        results = {}
        for mult in fig11.LOADS + ["storm"]:
            tspec = fig11.load_traffic(1.0 if mult == "storm" else mult,
                                       cap, device=dev)
            results[mult] = senv.serve_specs(
                app1, mspecs, tspec, cfg=cfg_s,
                faults=storm11 if mult == "storm" else None)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t_m
        soc_ops.fused_serve_episode = serve_ops
        soc_kernel.soc_step_serve = serve_kernel
        counts["mlp_serving"] = read()
        want = launches(soc_step_episode=2 * iters + 1,
                        soc_step_episode_mlp=iters,
                        soc_step_serve_mlp=len(fig11.LOADS),
                        soc_step_serve_mlp_faulted=1)
        if counts["mlp_serving"] != want or len(calls) != 6:
            fail(f"MLP serving launched "
                 f"{dict(zip(KERNELS, counts['mlp_serving']))}, expected "
                 f"{dict(zip(KERNELS, want))}")
        for mult, (carry, mqs, mres) in results.items():
            ex = mres.executed
            if not (bool(torch.isfinite(carry.wpack).all())
                    and bool(torch.isfinite(mres.latency).all())
                    and int(ex.sum()) > 0):
                fail(f"MLP serving {mult}: non-finite or empty results")
            if torch.equal(carry.wpack[0], net.wpack[0]):
                fail(f"MLP serving {mult}: the learning network's pack did "
                     "not change")
            if not torch.equal(carry.wpack[1], net.wpack[0]):
                fail(f"MLP serving {mult}: the frozen network's pack "
                     "changed")
            if not bool(mqs.frozen[:2].all()):
                fail(f"MLP serving {mult}: a placeholder Q-state learned")
            print(f"mlp serving {mult}{'x' if mult != 'storm' else ''}: "
                  "served " + ", ".join(
                      f"{n} {int(ex[i].sum())}/{n_req}" for i, n in
                      enumerate(("network", "frozen", "table", "non_coh")))
                  + f"; degraded steps {int(mres.degraded.sum())}; "
                  f"learning pack moved by "
                  f"{float((carry.wpack[0] - net.wpack[0]).abs().max()):.4g}")
        # every launch against the plain version on its own inputs: the
        # four lighter loads in one plain call (the plain step's cost is
        # per request, not per stream), the 2x and the storm launches each
        # alone, timed
        def joined(group):
            """One plain call's arguments for the launches of ``group``,
            their streams stacked."""
            a0, kw0, _ = group[0]
            args = [a0[0], torch.cat([g[0][1] for g in group]), a0[2],
                    soc_ref.ServeParams(*(torch.cat([
                        soc_ref.serve_params_tensors(g[0][3], 4, dev)[f]
                        for g in group]) for f in range(9))),
                    soc_ref.ServeCarry(*(
                        None if group[0][0][4][f] is None
                        else torch.cat([g[0][4][f] for g in group])
                        for f in range(10))),
                    soc_ref.StepInputs(*(
                        None if group[0][0][5][f] is None
                        else torch.cat([g[0][5][f] for g in group])
                        for f in range(len(soc_ref.StepInputs._fields)))),
                    *(torch.cat([g[0][j] for g in group])
                      for j in (6, 7, 8))]
            m0 = kw0["mlp"]
            return args, dict(
                qfun=torch.cat([g[1]["qfun"] for g in group]),
                mlp_lr=torch.cat([g[1]["mlp"].lr for g in group]),
                mlp_dims=socnn.mlp_dims(m0.cfg), mlp_feats=m0.cfg.features)

        errs, plain = {}, {}
        for label, group in (("loads", calls[:4]), ("2x", calls[4:5]),
                             ("storm", calls[5:6])):
            args, kw = joined(group)
            torch.cuda.synchronize()
            t_p = time.perf_counter()
            rc, ry = soc_ref.serve_episode_ref(*args, **kw)
            torch.cuda.synchronize()
            plain[label] = (time.perf_counter() - t_p) * 1e3
            for i, (_, _, (kc, ky)) in enumerate(group):
                sl = slice(4 * i, 4 * i + 4)
                what = (f"soc_step_serve_mlp"
                        f"{'_faulted' if label == 'storm' else ''} launch "
                        f"{label} {i}")
                err = compare_cols(torch, what, soc_ref.SERVE_YCOLS, ky,
                                   ry[sl], SERVE_INT_COLS)
                if err != 0.0 or not same_carry(
                        torch, kc, rc.map(lambda v: v[sl])):
                    fail(f"{what}: not bitwise equal to the plain version "
                         f"(max abs err {err})")
            errs[label] = 0.0
        print(f"mlp serving: all 6 launches (B=4, S={n_req}) bitwise equal "
              f"to ref.serve_episode_ref on their own inputs, packs "
              f"included; plain version {plain['loads']:.1f} ms for the "
              f"four lighter loads together, {plain['2x']:.1f} ms (2x), "
              f"{plain['storm']:.1f} ms (storm)")
        print(f"mlp_serving path on {card}: {path_s:.3f} s wall, launches "
              f"{dict(zip(KERNELS, counts['mlp_serving']))}")
        # the 2x and storm launches (the watchdog holds most of their
        # network steps off) and the 0.2x one (no degradation: the
        # network runs on every admitted request of its two streams)
        by_label = {"soc_step_serve_mlp": packed["4"],
                    "soc_step_serve_mlp_faulted": packed["faulted5"],
                    "0.2x": packed["0"]}
        return path_s, by_label, plain

    def small_mlp_serve(device, directory=None, die_after=None):
        """Three streams (a learning network, its frozen copy, fixed
        NON_COH) on SoC1 facing an overloading stream of 128 requests
        under storm 0.7; with ``directory`` one learning network's stream
        in three chunks through ``serve_checkpointed``."""
        e = vec.VecEnv(s1, seed=1, device=device)
        app = vec.compile_app(apps.make_application(s1, seed=50,
                                                    n_phases=2), s1, seed=4)
        sc = e._sched(app)
        net = socnn.init_mlp_qstate(prng.PRNGKey(7, device=device))
        tspec = traffic.bursty(4e-3, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                               priority=(1.0, 0.25), backoff=400.0,
                               overload_frac=0.35, prio_reserve=0.25, seed=3)
        cfg_ = qlearn.QConfig(decay_steps=200)
        if directory is None:
            specs = vec.stack_specs([
                vec.mlp_policy_spec(net, sc),
                vec.mlp_policy_spec(socnn.freeze(net), sc),
                vec.attach_placeholder_mlp(vec.fixed_policy_spec(
                    e.params, sc, 0))])
            return vec.ServeEnv(e, queue_cap=4, n_requests=128).serve_specs(
                app, specs, tspec, cfg=cfg_, faults=faults.storm(
                    128, 0.7, prng.PRNGKey(42), device=device))
        mgr = CheckpointManager(str(directory))
        if die_after is not None:
            mgr = _Killer(mgr, die_after)
        return vec.ServeEnv(e, queue_cap=4, n_requests=64).serve_checkpointed(
            app, vec.mlp_policy_spec(net, sc), tspec, mgr, n_chunks=3,
            cfg=cfg_, key=prng.PRNGKey(8))

    mlp_serving_s, mlp_packed, mlp_plain = mlp_serving_phase()
    (gc, gq, gr), (cc, cq, cr) = small_mlp_serve(dev), small_mlp_serve("cpu")
    same_tree("small MLP serving: card vs CPU", gr, cr, ("retries", "depth"))
    same_tree("small MLP serving: card vs CPU", gq, cq)
    same_tree("small MLP serving: card vs CPU", gc, cc)
    mck = ROOT / "build" / "chip_smoke_mlp_ckpt"
    shutil.rmtree(mck, ignore_errors=True)
    whole = small_mlp_serve(dev, mck / "whole")
    try:
        small_mlp_serve(dev, mck / "serve", die_after=1)
        fail("the killed checkpointed MLP serving did not stop")
    except _Crash:
        pass
    resumed = small_mlp_serve(dev, mck / "serve")
    on_cpu = small_mlp_serve("cpu", mck / "cpu")
    for cls, a, r, c in zip((soc_ref.ServeCarry, qlearn.QState,
                             vec.ServeResult), resumed, whole, on_cpu):
        same_tree("resumed MLP serving vs uninterrupted (card)", a, r,
                  cls._fields)
        same_tree("resumed MLP serving on the card vs CPU", a, c,
                  ("retries", "depth"))
    shutil.rmtree(mck, ignore_errors=True)
    print("small MLP serving (SoC1, 3 streams, 128 requests, overloaded, "
          "storm 0.7): card == CPU plain path, packs included; a "
          "checkpointed MLP stream killed after 1 of 3 chunks and resumed "
          "on the card: bitwise the uninterrupted stream, == CPU")

    # ---- 9s. flash_attention (K3) at the gemma2-9b path's shapes (soft-cap
    # 50, group 2 at head dim 256), its coverage probes, the Gemma-2 smoke
    # serve card == CPU, and gemma2-9b serving at full width ---------------
    gm = dict(causal=True, softcap=GM_SOFTCAP)
    gm_fa = {"prefill": qkv(*FA_GM_PREFILL, torch.bfloat16)}
    qm, kmc, vmc = qkv(*FA_GM_DECODE[:6], torch.bfloat16,
                       s_max=FA_GM_DECODE[6])
    gm_fa["decode"] = (qm, kmc[:, :FA_GM_DECODE[4]], vmc[:, :FA_GM_DECODE[4]])
    for feat in (gm, dict(gm, window=GM_WINDOW)):
        fa_err = max(fa_err, fa_vs_plain(
            f"gemma2 prefill {FA_GM_PREFILL} bf16 {feat}", *gm_fa["prefill"],
            body="tc_prefill", **feat))
    fa_err = max(fa_err, fa_vs_plain(
        f"gemma2 decode {FA_GM_DECODE[:6]} bf16 over a cache of "
        f"{FA_GM_DECODE[6]}, soft-cap {GM_SOFTCAP}", *gm_fa["decode"],
        body="split_decode", **gm))
    fa_vs_plain(f"gemma2 prefill {FA_GM_PREFILL} float32 {gm}",
                *qkv(*FA_GM_PREFILL, torch.float32), body="fp32_prefill",
                **gm)
    q32, kc32, vc32 = qkv(*FA_GM_DECODE[:6], torch.float32,
                          s_max=FA_GM_DECODE[6])
    fa_vs_plain(f"gemma2 decode {FA_GM_DECODE[:6]} float32 over a cache of "
                f"{FA_GM_DECODE[6]}, soft-cap {GM_SOFTCAP}", q32,
                kc32[:, :FA_GM_DECODE[4]], vc32[:, :FA_GM_DECODE[4]],
                body="split_decode", **gm)
    del q32, kc32, vc32
    fa_probe("gemma2 prefill", FA_GM_PREFILL, **gm)
    fa_probe("gemma2 local prefill", FA_GM_PREFILL, window=GM_WINDOW, **gm)
    fa_decode_probes("gemma2 decode", FA_GM_DECODE[:6], FA_GM_DECODE[6],
                     **gm)

    gscfg = smoke_config("gemma2-9b")
    g_smoke = lambda: lm.init_params(gscfg, torch.Generator().manual_seed(0),
                                     "cpu")
    gs_cpu = lm_serve.serve(gscfg, 2, 16, 8, device="cpu", params=g_smoke())
    gs_card = lm_serve.serve(gscfg, 2, 16, 8, device=dev,
                             params=g_smoke().to(dev))
    if not np.array_equal(gs_card["generated"], gs_cpu["generated"]):
        fail("Gemma-2 smoke serve: card and CPU generated different tokens")
    g_err = max((gs_card[k].cpu() - gs_cpu[k]).abs().max().item()
                for k in ("prefill_logits", "logits"))
    if g_err > LM_TOL:
        fail(f"Gemma-2 smoke serve: card logits {g_err} from the CPU's")
    print(f"gemma2-9b smoke serve (B=2, prompt 16 over rings of 8, gen 8, "
          f"float32): tokens equal on the card and the CPU, logits within "
          f"{g_err:.3e} (bound {LM_TOL})")

    gcfg9 = get_arch("gemma2-9b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    fa_launch, gm_caps = fa_kernel.launch, []

    def capped_launch(*a, **kw):     # the soft-cap of every K3 launch
        gm_caps.append(kw.get("softcap", 0.0))
        return fa_launch(*a, **kw)

    fa_kernel.launch = capped_launch
    t_gm = time.perf_counter()
    gm_out = lm_serve.serve(gcfg9, batch=QWEN_BATCH,
                            prompt_len=QWEN_PROMPT, gen=QWEN_GEN, seed=0,
                            device=dev)
    torch.cuda.synchronize()
    gemma_s = time.perf_counter() - t_gm
    fa_kernel.launch = fa_launch
    counts["gemma2_serve"] = read()
    if len(gm_caps) != 42 * 33 or set(gm_caps) != {GM_SOFTCAP}:
        fail(f"gemma2-9b serve: K3 soft-caps {sorted(set(gm_caps))} over "
             f"{len(gm_caps)} launches, expected {GM_SOFTCAP} on 1386")
    check_bodies("gemma2_serve", gcfg9.n_layers, gcfg9.n_layers * QWEN_GEN)
    want_gm = launches(flash_attention=gcfg9.n_layers * (1 + QWEN_GEN))
    if counts["gemma2_serve"] != want_gm or want_gm[6] != 42 * 33:
        fail(f"gemma2-9b serve launched "
             f"{dict(zip(KERNELS, counts['gemma2_serve']))}, expected "
             f"{dict(zip(KERNELS, want_gm))}")
    if not (bool(torch.isfinite(gm_out["prefill_logits"]).all())
            and bool(torch.isfinite(gm_out["logits"]).all())
            and float(gm_out["logits"].abs().max()) <= gcfg9.final_softcap):
        fail("gemma2-9b serve: non-finite logits or logits past the "
             "final soft-cap")
    if gm_out["generated"].shape != (QWEN_BATCH, QWEN_GEN):
        fail(f"gemma2-9b serve: generated {gm_out['generated'].shape}")
    gm_mem = torch.cuda.max_memory_allocated()
    print(f"gemma2-9b serve (B={QWEN_BATCH}, prompt {QWEN_PROMPT}, gen "
          f"{QWEN_GEN}, bf16 compute, float32 parameters, "
          f"{gcfg9.param_count():,} parameters) on {card}: prefill "
          f"{gm_out['prefill_s']:.4f} s, decode {gm_out['decode_s']:.4f} s "
          f"({gm_out['decode_s'] / QWEN_GEN * 1e3:.2f} ms/step, "
          f"{gm_out['decode_tok_per_s']:.1f} tok/s), bf16 weight copy "
          f"{gm_out['cast_s']:.4f} s, {gemma_s:.3f} s wall with the weights' "
          f"init; peak memory {gm_mem / 2**30:.2f} GiB ({gm_mem / 1e9:.2f} "
          f"GB); launches {dict(zip(KERNELS, counts['gemma2_serve']))} (every "
          f"one with soft-cap {GM_SOFTCAP}); first tokens "
          f"{gm_out['generated'][0, :8].tolist()}")
    del gm_out
    torch.cuda.empty_cache()

    # ---- 9t. flash_attention (K3) at qwen2-vl-2b's (group 6) and
    # musicgen-large's (group 1) shapes, in bf16 and float32, and their
    # coverage probes -----------------------------------------------------
    new_fa = {}
    for tag, pre, dec in (("qwen2-vl", FA_VL_PREFILL, FA_VL_DECODE),
                          ("musicgen", FA_MG_PREFILL, FA_MG_DECODE)):
        qn, kn, vn = qkv(*dec[:6], torch.bfloat16, s_max=dec[6])
        new_fa[tag] = {"prefill": qkv(*pre, torch.bfloat16),
                       "decode": (qn, kn[:, :dec[4]], vn[:, :dec[4]])}
        fa_err = max(fa_err, fa_vs_plain(
            f"{tag} prefill {pre} bf16 causal", *new_fa[tag]["prefill"],
            body="tc_prefill"))
        fa_err = max(fa_err, fa_vs_plain(
            f"{tag} decode {dec[:6]} bf16 over a cache of {dec[6]}",
            *new_fa[tag]["decode"], body="split_decode"))
        fa_vs_plain(f"{tag} prefill {pre} float32 causal",
                    *qkv(*pre, torch.float32), body="fp32_prefill")
        q32, kc32, vc32 = qkv(*dec[:6], torch.float32, s_max=dec[6])
        fa_vs_plain(f"{tag} decode {dec[:6]} float32 over a cache of "
                    f"{dec[6]}", q32, kc32[:, :dec[4]], vc32[:, :dec[4]],
                    body="split_decode")
        del q32, kc32, vc32
        fa_probe(f"{tag} prefill", pre, causal=True)
        fa_decode_probes(f"{tag} decode", dec[:6], dec[6], causal=True)
    torch.cuda.empty_cache()

    # ---- 9u. a bf16 smoke serve, card against CPU, through the tensor-core
    # bodies: the card decodes the CPU's tokens, so every step's logits
    # compare (within 2e-2) ------------------------------------------------
    bcfg = smoke_config("qwen3-8b").replace(compute_dtype="bfloat16",
                                            head_dim=64)
    b_params = lambda: lm.init_params(bcfg, torch.Generator().manual_seed(0),
                                      "cpu")
    b_cpu = lm_serve.serve(bcfg, 2, BF16_PROMPT, BF16_GEN, device="cpu",
                           params=b_params())
    b_prompt = torch.from_numpy(host_batch(
        bcfg, DataConfig(BF16_PROMPT, 2, seed=0), 0)["tokens"]).to(dev)
    b_feed = torch.cat([b_cpu["prefill_logits"].argmax(-1).to(torch.int32),
                        torch.from_numpy(b_cpu["generated"][:, :-1])],
                       dim=1).to(dev)
    torch.cuda.synchronize()
    reset_counts()
    t_b = time.perf_counter()
    b_run = lm.compute_copy(bcfg, b_params().to(dev))
    b_cache, b_logits = lm.prefill(bcfg, b_run, {"tokens": b_prompt},
                                   max_len=BF16_PROMPT + BF16_GEN)
    b_steps = [b_logits]
    for i in range(BF16_GEN):
        b_cache, b_logits = lm.decode_step(
            bcfg, b_run, b_cache, {"tokens": b_feed[:, i:i + 1]},
            BF16_PROMPT + i)
        b_steps.append(b_logits)
    torch.cuda.synchronize()
    bf16_smoke_s = time.perf_counter() - t_b
    counts["bf16_smoke_serve"] = read()
    check_bodies("bf16_smoke_serve", bcfg.n_layers,
                 bcfg.n_layers * BF16_GEN)
    b_want = [b_cpu["prefill_logits"]] + [
        b_cpu["logits"][:, i:i + 1] for i in range(BF16_GEN)]
    b_err = max((g.cpu() - w).abs().max().item()
                for g, w in zip(b_steps, b_want))
    if not b_err <= BF16_TOL:
        fail(f"bf16 smoke serve: card logits {b_err} from the CPU's")
    print(f"bf16 smoke serve (Qwen3 smoke at head dim 64, B=2, prompt "
          f"{BF16_PROMPT}, gen {BF16_GEN}, bf16) on {card}: every step's "
          f"logits within {b_err:.3e} of the CPU's (bound {BF16_TOL}), the "
          f"card fed the CPU's tokens; launches "
          f"{dict(zip(KERNELS, counts['bf16_smoke_serve']))}")
    del b_run, b_cache

    # ---- 9v. arctic-480b's smoke serve (the dense residual beside the MoE),
    # card against CPU in float32: K4 through fp32_tiled, K3 in float32 ---
    acfg = smoke_config("arctic-480b")
    a_params = lambda: lm.init_params(acfg, torch.Generator().manual_seed(0),
                                      "cpu")
    a_cpu = lm_serve.serve(acfg, 2, 16, 8, device="cpu", params=a_params())
    torch.cuda.synchronize()
    reset_counts()
    t_a = time.perf_counter()
    a_card = lm_serve.serve(acfg, 2, 16, 8, device=dev,
                            params=a_params().to(dev))
    torch.cuda.synchronize()
    arctic_smoke_s = time.perf_counter() - t_a
    counts["arctic_smoke_serve"] = read()
    a_bodies = dict(gmm_ops.body_launches)
    want_a = launches(flash_attention=acfg.n_layers * 9,
                      moe_gmm=acfg.n_layers * 3 * 9)
    if (counts["arctic_smoke_serve"] != want_a
            or a_bodies["fp32_tiled"] != want_a[KERNELS.index("moe_gmm")]):
        fail(f"arctic smoke serve launched "
             f"{dict(zip(KERNELS, counts['arctic_smoke_serve']))} (K4 "
             f"bodies {a_bodies}), expected {dict(zip(KERNELS, want_a))}")
    if not np.array_equal(a_card["generated"], a_cpu["generated"]):
        fail("arctic smoke serve: card and CPU generated different tokens")
    a_err = max((a_card[k].cpu() - a_cpu[k]).abs().max().item()
                for k in ("prefill_logits", "logits"))
    if a_err > LM_TOL:
        fail(f"arctic smoke serve: card logits {a_err} from the CPU's")
    print(f"arctic-480b smoke serve (B=2, prompt 16, gen 8, float32, the "
          f"dense residual beside 4 experts top-2) on {card}: tokens equal "
          f"on the card and the CPU, logits within {a_err:.3e} (bound "
          f"{LM_TOL}); launches "
          f"{dict(zip(KERNELS, counts['arctic_smoke_serve']))}, K4 bodies "
          f"{a_bodies}")

    # ---- 9w. qwen2-vl-2b, musicgen-large and Qwen3-8B with the int8 KV
    # cache, serving at full width ------------------------------------------
    def lm_path(path, cfg, gen_shape, what):
        """One LM serving path at full width: 4 synthetic prompts of 2,048
        tokens, 32 greedy tokens, bf16 compute, random float32 weights
        from seed 0 on the card; every attention through K3 (asserted per
        body), finite logits; returns its wall and numbers, the peak
        memory also above what the script held before the path."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t_l = time.perf_counter()
        out = lm_serve.serve(cfg, batch=QWEN_BATCH, prompt_len=QWEN_PROMPT,
                             gen=QWEN_GEN, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_l
        counts[path] = read()
        check_bodies(path, cfg.n_layers, cfg.n_layers * QWEN_GEN)
        want = launches(flash_attention=cfg.n_layers * (1 + QWEN_GEN))
        if counts[path] != want:
            fail(f"{path} launched {dict(zip(KERNELS, counts[path]))}, "
                 f"expected {dict(zip(KERNELS, want))}")
        if not (bool(torch.isfinite(out["prefill_logits"]).all())
                and bool(torch.isfinite(out["logits"]).all())):
            fail(f"{path}: non-finite logits")
        if out["generated"].shape != gen_shape:
            fail(f"{path}: generated {out['generated'].shape}, expected "
                 f"{gen_shape}")
        mem = torch.cuda.max_memory_allocated()
        row = dict(prefill_s=out["prefill_s"],
                   decode_ms=out["decode_s"] / QWEN_GEN * 1e3,
                   tok_s=out["decode_tok_per_s"], peak_gib=mem / 2**30,
                   own_peak_gib=(mem - base) / 2**30, wall_s=wall,
                   params=cfg.param_count())
        print(f"{cfg.name} serve{what} (B={QWEN_BATCH}, prompt {QWEN_PROMPT},"
              f" gen {QWEN_GEN}, bf16 compute, float32 parameters, "
              f"{row['params']:,} parameters) on {card}: prefill "
              f"{row['prefill_s']:.4f} s, decode {out['decode_s']:.4f} s "
              f"({row['decode_ms']:.2f} ms/step, {row['tok_s']:.1f} tok/s), "
              f"bf16 weight copy {out['cast_s']:.4f} s, {wall:.3f} s wall "
              f"with the weights' init; peak memory {row['peak_gib']:.2f} "
              f"GiB ({row['own_peak_gib']:.2f} above what the script held "
              f"before); launches {dict(zip(KERNELS, counts[path]))}; first "
              f"tokens {out['generated'].reshape(-1)[:8].tolist()}")
        del out
        torch.cuda.empty_cache()
        return wall, row

    def cache_bytes(cfg):
        c = lm.init_cache(cfg, QWEN_BATCH, QWEN_PROMPT + QWEN_GEN, dev)
        n = sum(t.nbytes for kv in c for e in kv
                for t in (e if isinstance(e, tuple) else (e,)))
        del c
        return n

    vcfg, mcfg = get_arch("qwen2-vl-2b"), get_arch("musicgen-large")
    i8cfg = qcfg.replace(kv_cache_dtype="int8")
    lm_rows = {}
    qwen2vl_s, lm_rows["qwen2-vl-2b"] = lm_path(
        "qwen2vl_serve", vcfg, (QWEN_BATCH, QWEN_GEN),
        f" ({vcfg.vision_tokens} vision tokens of {vcfg.vision_dim}, M-RoPE "
        f"{vcfg.mrope_sections})")
    musicgen_s, lm_rows["musicgen-large"] = lm_path(
        "musicgen_serve", mcfg, (QWEN_GEN, QWEN_BATCH, mcfg.n_codebooks, 1),
        f" ({mcfg.n_codebooks} codebooks, sinusoidal positions)")
    # the int8 cache's path, then the bf16 cache's again beside it, so
    # both run warm and over the same memory held by the script
    qwen_int8_s, lm_rows["qwen3-8b int8"] = lm_path(
        "qwen3_int8_serve", i8cfg, (QWEN_BATCH, QWEN_GEN),
        " (int8 KV cache)")
    qwen_again_s, lm_rows["qwen3-8b bf16"] = lm_path(
        "qwen3_serve_beside_int8", qcfg, (QWEN_BATCH, QWEN_GEN),
        " (bf16 KV cache, again beside the int8 one)")
    lm_rows["qwen3-8b bf16, the first path"] = qwen_bf16
    i8, bf = lm_rows["qwen3-8b int8"], lm_rows["qwen3-8b bf16"]
    i8["cache_bytes"], bf["cache_bytes"] = (cache_bytes(i8cfg),
                                            cache_bytes(qcfg))
    print(f"qwen3-8b, int8 / bf16 KV cache, on {card}: prefill "
          f"{i8['prefill_s']:.4f} / {bf['prefill_s']:.4f} s, decode "
          f"{i8['decode_ms']:.2f} / {bf['decode_ms']:.2f} ms/step, peak "
          f"{i8['own_peak_gib']:.2f} / {bf['own_peak_gib']:.2f} GiB above "
          f"what the script held ({i8['peak_gib']:.2f} / "
          f"{bf['peak_gib']:.2f} in all); cache {i8['cache_bytes']:,} / "
          f"{bf['cache_bytes']:,} bytes "
          f"({i8['cache_bytes'] / bf['cache_bytes']:.4f})")
    (ROOT / "chiprun_out" / "lm_serving_port.json").write_text(
        json.dumps({"card": card, "rows": lm_rows}, indent=1))

    # ---- 9x. the Fig. 6 and Fig. 9 --fidelity paths at full SoC and app
    # width, cut depth ------------------------------------------------------
    print(f"fidelity cuts: Fig. 6 --fidelity at the first {FID6_WEIGHTS} of "
          f"15 weightings x {FID6_ITERS} of 10 iterations (SoC-motiv-par, "
          f"the 6-phase train app, the seed-900 6-phase test app), its "
          f"classification held against the batched path's on the same "
          f"weightings (2 seeds); Fig. 9 _run_des on {FID9_LANE[0]}-"
          f"{FID9_LANE[1]}, 1 of 8 lanes, x {FID9_ITERS} of 10 iterations "
          f"(8-phase apps, the profiled suite); Fig. 9 _des_crosscheck on "
          f"all 8 lanes")
    fid_s = {}

    def fid_path(path, run, want):
        torch.cuda.synchronize()
        reset_counts()
        t_f = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        fid_s[path] = time.perf_counter() - t_f
        counts[path] = read()
        if counts[path] != want:
            fail(f"{path} launched {dict(zip(KERNELS, counts[path]))}, "
                 f"expected {dict(zip(KERNELS, want))}")
        return out

    pts6, sim6 = fid_path("fig6_des", lambda: fig6d.des_points(
        fig6d.WEIGHTS[:FID6_WEIGHTS], FID6_ITERS, dev), launches())
    bpts6, _ = fid_path("fig6_des_agreement", lambda: fig6d.batched_points(
        fig6d.WEIGHTS[:FID6_WEIGHTS], FID6_ITERS, 2, dev),
        launches(soc_step_episode=FID6_ITERS + 2))   # + NON_COH, agents
    cls6, bcls6 = fig6d.classify(pts6), fig6d.classify(bpts6)
    if not all(math.isfinite(v) for p in pts6.values() for v in p.values()):
        fail("fig6_des: non-finite points")
    if cls6 != bcls6:
        fail(f"fig6_des: des_agreement false: DES {cls6}, batched {bcls6}")
    print(f"fig6_des on {card}: {fid_s['fig6_des']:.3f} s wall, "
          f"{sim6.invocations} invocations "
          f"({sim6.invocations / fid_s['fig6_des']:.1f} a second); points "
          f"{json.dumps(pts6)}; des_agreement True ({cls6}; the batched "
          f"path {fid_s['fig6_des_agreement']:.3f} s)")
    x9 = fid_path("fig9_des_xcheck", lambda: fig9.crosscheck_port(dev),
                  launches(soc_step_episode=1))
    if not x9["agree"]:
        fail(f"fig9_des_xcheck: max_rel_err {x9['max_rel_err']}, not below "
             f"1e-3")
    print(f"fig9_des_xcheck on {card}: {fid_s['fig9_des_xcheck']:.3f} s "
          f"wall, 8 lanes x 5 policies, max_rel_err "
          f"{x9['max_rel_err']:.3g}, agree True")
    r9d = fid_path("fig9_des", lambda: fig9.run_des(dev, [FID9_LANE],
                                                    FID9_ITERS), launches())
    row9 = r9d[f"{FID9_LANE[0]}-{FID9_LANE[1]}"]
    if not all(math.isfinite(v) for fam in fig9.FAMILIES
               for v in row9[fam]):
        fail("fig9_des: non-finite rows")
    e9 = r9d["_engine"]
    print(f"fig9_des on {card}: {fid_s['fig9_des']:.3f} s wall, "
          f"{e9['invocations']} invocations "
          f"({e9['invocations_per_s']:.1f} a second); "
          + " ".join(f"{fam}=({row9[fam][0]:.6f}, {row9[fam][1]:.6f})"
                     for fam in fig9.FAMILIES)
          + f"; headline {json.dumps(r9d['_headline'])}")
    (ROOT / "chiprun_out" / "fidelity_port.json").write_text(json.dumps(
        {"fig6_des": pts6, "fig6_batched": bpts6, "fig9_des_xcheck": x9,
         "fig9_des": r9d, "walls_s": fid_s}, indent=1))
    print(f"fidelity paths on {card}: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in fid_s.items())
          + f"; {sum(fid_s.values()):.3f} s in all")

    # ---- 9y. LM training: each kernel's gradient against autodiff of its
    # plain version, card against CPU at smoke width, qwen2-vl-2b at full
    # width through the launcher and under each remat arm, the autotuner,
    # and a killed and resumed checkpointed run ----------------------------
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import autotune as lm_autotune
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train as lm_train
    from repro_torch.optim import compress as lm_compress
    train_s, train_rows = {}, {}
    torch.cuda.empty_cache()

    def grad_check(what, fn, plain, inputs, fwd_tol):
        """``fn`` (the kernel's wrapper) against ``plain`` on the same
        inputs: the forward within ``fwd_tol``, the gradients of a random
        projection of the outputs within GRAD_CHECK_TOL of each input's
        largest gradient.  The wrapper's backward is autodiff of the same
        plain version on the same saved inputs, so the gradient half
        checks only its wiring (which inputs get gradients, and in which
        order); the forward bound is the check of the kernel.  Returns
        (forward error, gradient error)."""
        diff = [x for x in inputs if x is not None and x.requires_grad]
        gen = torch.Generator(device=dev).manual_seed(5)

        def grads(f):
            out = f(*inputs)
            outs = out if isinstance(out, tuple) else (out,)
            loss = sum((o.float() * torch.randn(o.shape, generator=gen,
                                                device=dev)).sum()
                       for o in outs)
            return [o.detach() for o in outs], torch.autograd.grad(loss,
                                                                   diff)
        gen.manual_seed(5)
        outs, got = grads(fn)
        gen.manual_seed(5)
        pouts, want = grads(plain)
        fwd = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(outs, pouts))
        err = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max().clamp_min(1e-30)).item()
                  for a, b in zip(got, want))
        if not (fwd <= fwd_tol and err <= GRAD_CHECK_TOL):
            fail(f"{what}: forward {fwd} (bound {fwd_tol}), gradients "
                 f"{err} of their largest (bound {GRAD_CHECK_TOL})")
        print(f"gradient check {what} on {card}: forward within {fwd:.3e} "
              f"of the plain version, gradients within {err:.3e} of their "
              f"largest magnitude of autodiff through it")
        return fwd, err

    g_gen = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *s, dt=torch.float32: torch.randn(
        *s, generator=g_gen, device=dev).to(dt).requires_grad_(True)
    grad_errs = {}
    b_, h_, hkv_, s_, hd_ = FA_VL_TRAIN
    grad_errs["flash_attention"] = grad_check(
        f"K3 at qwen2-vl-2b's training shape (B, S, H, Hkv, hd) "
        f"{(b_, s_, h_, hkv_, hd_)} bf16 causal",
        lambda q, k, v: fa_ops.flash_attention(q, k, v, causal=True),
        lambda q, k, v: fa_ops._plain(q, k, v, causal=True, window=0,
                                      softcap=0.0),
        [rnd(b_, s_, h_, hd_, dt=torch.bfloat16),
         rnd(b_, s_, hkv_, hd_, dt=torch.bfloat16),
         rnd(b_, s_, hkv_, hd_, dt=torch.bfloat16)], BF16_TOL)
    torch.cuda.empty_cache()
    lead, e_, c_, d_, f_ = GMM_PREFILL[0], *GMM_PREFILL[1:]
    sizes_t = torch.randint(0, c_ + 1, (lead, e_), generator=g_gen,
                            device=dev, dtype=torch.int32)
    sizes_t[:, GMM_REAL:] = 0
    grad_errs["moe_gmm"] = grad_check(
        f"K4 at granite's prefill gate/up (B, E, C, D, F) {GMM_PREFILL} "
        f"bf16", gmm_ops.moe_gmm, gmm_ref.gmm_ref,
        [rnd(lead, e_, c_, d_, dt=torch.bfloat16),
         (rnd(e_, d_, f_) / d_ ** 0.5).to(torch.bfloat16).detach()
         .requires_grad_(True), sizes_t], GMM_BF16_TOL["atol"])
    torch.cuda.empty_cache()
    rb, rh, rt, rk = RWKV_TRAIN
    logw = (-torch.exp(torch.randn(rb, rh, rt, rk, generator=g_gen,
                                   device=dev) * 0.5 - 0.7)
            ).requires_grad_(True)
    grad_errs["rwkv6_scan"] = grad_check(
        f"K5 at (B, H, T, K) {RWKV_TRAIN} from a random state (rwkv6-3b's "
        f"prefill at T {rt} of 2,048: the plain recompute steps T times)",
        rw_ops.rwkv6_scan,
        lambda r, k, v, lw, u, s0: rw_ops._plain(
            r, k, v, torch.clamp(lw, min=rw_ops.LOGW_MIN), u, s0),
        [rnd(rb, rh, rt, rk) * 0.5, rnd(rb, rh, rt, rk) * 0.5,
         rnd(rb, rh, rt, rk), logw, rnd(rh, rk) * 0.5,
         rnd(rb, rh, rk, rk) * 0.1], TOL)
    torch.cuda.empty_cache()
    gb, gt, gw = RG_SCAN
    log_a = (-torch.rand(gb, gt, gw, generator=g_gen, device=dev) * 0.5
             ).requires_grad_(True)
    grad_errs["rglru_scan"] = grad_check(
        f"K6 at recurrentgemma-9b's prefill (B, T, W) {RG_SCAN}",
        rg_ops.rglru_scan, lambda a, b: rg_ops._plain(a, b),
        [log_a, rnd(gb, gt, gw)], RG_TOL)
    del logw, log_a, sizes_t
    torch.cuda.empty_cache()

    # card against CPU at smoke width: the loss and every gradient of one
    # step, then the parameters after 5 train steps (AdamW; arctic's
    # Adafactor with remat="full"; Qwen3 with int8 compression)
    def state_to(state, device):
        """A copy of a train state on ``device``, its parameters a
        trainable copy of the module."""
        def move(x):
            if torch.is_tensor(x):
                return x.detach().to(device, copy=True)
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            if isinstance(x, tuple):
                return type(x)(*map(move, x))
            return x
        out = {k: move(v) for k, v in state.items() if k != "params"}
        out["params"] = lm.trainable(copy.deepcopy(state["params"]).to(device))
        return out

    def smoke_train(path, arch, compress=False):
        cfg = smoke_config(arch)
        cpu = lm_steps.make_train_state(cfg, 0, "cpu")
        if compress:
            cpu["ef"] = lm_compress.init_ef(dict(
                cpu["params"].named_parameters()))
        card_state = state_to(cpu, dev)
        batches = [host_batch(cfg, DataConfig(SMOKE_SEQ, 2, seed=0), i)
                   for i in range(SMOKE_STEPS)]
        to = lambda b, d: {k: torch.from_numpy(v).to(d) for k, v in b.items()}

        def run(state, d):
            named = dict(state["params"].named_parameters())
            loss, _ = lm.loss_fn(cfg, state["params"], to(batches[0], d))
            g = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
            step = lm_steps.make_train_step(cfg, grad_compress=compress,
                                            total_steps=SMOKE_STEPS)
            for b in batches:
                state, _ = step(state, to(b, d))
            return float(loss.detach()), dict(zip(named, g)), state

        torch.cuda.synchronize()
        reset_counts()
        t_p = time.perf_counter()
        c_loss, c_g, card_state = run(card_state, dev)
        torch.cuda.synchronize()
        train_s[path] = time.perf_counter() - t_p
        counts[path] = read()
        p_loss, p_g, cpu = run(cpu, "cpu")
        loss_err = abs(c_loss - p_loss)
        g_err = max(((c_g[k].cpu() - p_g[k]).abs().max()
                     / p_g[k].abs().max().clamp_min(1e-30)).item()
                    for k in p_g if p_g[k] is not None and p_g[k].numel())
        if any((c_g[k] is None) != (p_g[k] is None) for k in p_g):
            fail(f"{path}: gradients missing on one side only")
        # a zero-initialised tensor has moved ~1e-5 after 5 warmup steps:
        # its errors are taken against 1e-2
        cp = dict(card_state["params"].named_parameters())
        p_err = max(((cp[k].detach().cpu() - p).abs().max()
                     / p.abs().max().clamp_min(1e-2)).item()
                    for k, p in cpu["params"].named_parameters()
                    if p.numel())
        if not (loss_err <= LM_TOL * max(1.0, abs(p_loss))
                and g_err <= SMOKE_GRAD_TOL and p_err <= SMOKE_PARAM_TOL):
            fail(f"{path}: card vs CPU loss {loss_err}, gradients {g_err}, "
                 f"parameters {p_err}")
        kinds = lm.layer_kinds(cfg)
        fwd = 1 + SMOKE_STEPS
        again = 2 if cfg.remat in ("full", "dots") else 1
        n_attn = sum(k.startswith("attn") for k in kinds)
        want = launches(
            flash_attention=fwd * again * n_attn,
            moe_gmm=fwd * again * 3 * n_attn if cfg.n_experts else 0,
            rwkv6_scan=fwd * again * kinds.count("rwkv"),
            rglru_scan=fwd * again * kinds.count("rg"))
        if counts[path] != want:
            fail(f"{path} launched {dict(zip(KERNELS, counts[path]))}, "
                 f"expected {dict(zip(KERNELS, want))}")
        train_rows[path] = dict(loss_err=loss_err, grad_err=g_err,
                                param_err=p_err, wall_s=train_s[path])
        print(f"{path} ({cfg.name}, {cfg.optimizer}, remat {cfg.remat}"
              f"{', int8 compression' if compress else ''}, B=2, seq "
              f"{SMOKE_SEQ}, float32) on {card} against the CPU: loss "
              f"within {loss_err:.3e}, every gradient within {g_err:.3e} "
              f"of its largest (bound {SMOKE_GRAD_TOL}), parameters after "
              f"{SMOKE_STEPS} steps within {p_err:.3e} (bound "
              f"{SMOKE_PARAM_TOL}); launches "
              f"{dict(zip(KERNELS, counts[path]))}")

    for path, arch, comp in (
            ("granite_smoke_train", "granite-moe-3b-a800m", False),
            ("rwkv6_smoke_train", "rwkv6-3b", False),
            ("recurrentgemma_smoke_train", "recurrentgemma-9b", False),
            ("qwen2vl_smoke_train", "qwen2-vl-2b", False),
            ("qwen3_smoke_train_compress", "qwen3-8b", True),
            ("arctic_smoke_train", "arctic-480b", False)):
        smoke_train(path, arch, comp)

    # qwen2-vl-2b at full width through the launcher: 6 steps, then one
    # step under each remat arm
    vl = get_arch("qwen2-vl-2b")

    def vl_train(path, cfg, steps, batch, per_forward):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        finite = []

        def hook(grads):
            if not finite:
                finite.append(bool(torch.stack([torch.isfinite(g).all()
                                                for g in grads.values()
                                                ]).all()))
        reset_counts()
        t_v = time.perf_counter()
        out = lm_train.run(cfg, steps=steps, batch=batch, seq=VL_SEQ,
                           log_every=1, device=dev, timed=True,
                           grads_hook=hook)
        torch.cuda.synchronize()
        train_s[path] = time.perf_counter() - t_v
        counts[path] = read()
        bodies = dict(fa_ops.body_launches)
        want_k3 = steps * per_forward
        if (counts[path] != launches(flash_attention=want_k3)
                or bodies["tc_prefill"] != want_k3):
            fail(f"{path} launched {dict(zip(KERNELS, counts[path]))}, K3 "
                 f"bodies {bodies}; expected {want_k3} tc_prefill")
        if not finite or not finite[0]:
            fail(f"{path}: a non-finite gradient at step 1")
        if not all(math.isfinite(x) for x in out["losses"]):
            fail(f"{path}: non-finite loss {out['losses']}")
        mem = torch.cuda.max_memory_allocated()
        timed = out["phases"][1:] or out["phases"]
        step_s = out["step_s"][1:] or out["step_s"]
        med = lambda xs: float(np.median(xs))
        row = dict(batch=batch, seq=VL_SEQ, remat=cfg.remat, steps=steps,
                   losses=out["losses"], grad_norms=out["grad_norms"],
                   step_s=med(step_s),
                   forward_s=med([p["forward"] for p in timed]),
                   backward_s=med([p["backward"] for p in timed]),
                   optimizer_s=med([p["optimizer"] for p in timed]),
                   tok_s=batch * VL_SEQ / med(step_s),
                   own_peak_gib=(mem - base) / 2**30, peak_gib=mem / 2**30,
                   k3_per_step=want_k3 // steps, wall_s=train_s[path],
                   params=cfg.param_count())
        train_rows[path] = row
        print(f"{path} ({cfg.name}, {row['params']:,} parameters, B={batch}"
              f", seq {VL_SEQ}, bf16 compute, float32 weights and AdamW "
              f"moments, remat {cfg.remat}, {steps} step(s)) on {card}: "
              f"step {row['step_s']:.4f} s (median of steps "
              f"{'2-' + str(steps) if steps > 2 else steps}: forward "
              f"{row['forward_s']:.4f}, backward {row['backward_s']:.4f}, "
              f"optimizer {row['optimizer_s']:.4f}), {row['tok_s']:.0f} "
              f"tokens a second, peak {row['own_peak_gib']:.2f} GiB above "
              f"what the script held ({row['peak_gib']:.2f} in all); losses "
              f"{[round(x, 4) for x in out['losses']]}; K3 "
              f"{row['k3_per_step']} tc_prefill launches a step")
        return row

    vl_train("qwen2vl_train", vl, VL_STEPS, QWEN_BATCH, vl.n_layers)
    arms = {remat: vl_train(f"qwen2vl_train_remat_{remat}",
                            vl.replace(remat=remat), VL_ARM_STEPS,
                            QWEN_BATCH,
                            (1 if remat == "none" else 2) * vl.n_layers)
            for remat in ("none", "dots", "full")}
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    for remat in ("dots", "full"):
        got, want = arms[remat], arms["none"]
        d_loss = rel(got["losses"][0], want["losses"][0])
        d_norm = rel(got["grad_norms"][0], want["grad_norms"][0])
        got["step1_vs_none"] = dict(loss=d_loss, grad_norm=d_norm)
        if not (d_loss <= REMAT_TOL and d_norm <= REMAT_TOL):
            fail(f"qwen2vl_train_remat_{remat}: step 1 loss "
                 f"{got['losses'][0]!r} and gradient norm "
                 f"{got['grad_norms'][0]!r} against remat none's "
                 f"{want['losses'][0]!r} and {want['grad_norms'][0]!r}")
        print(f"qwen2vl_train_remat_{remat} on {card}: step 1 loss within "
              f"{d_loss:.3e} and gradient norm within {d_norm:.3e} of remat "
              f"none's (relative; bound {REMAT_TOL})")

    # the autotuner: 40 steps of Qwen3-8B's smoke config
    acfg_t = smoke_config("qwen3-8b")
    orch_t = lm_autotune.MemoryModeOrchestrator(
        acfg_t, ShapeSpec("t", "train", 64, 8), seed=0, total_steps=40)
    a_state = lm_steps.make_train_state(acfg_t, 0, dev)
    a_batches = [{k: torch.from_numpy(v).to(dev) for k, v in host_batch(
        acfg_t, DataConfig(64, 8, seed=i), i).items()} for i in range(40)]
    torch.cuda.synchronize()
    reset_counts()
    t_at = time.perf_counter()
    for b in a_batches:
        a_state, a_m = orch_t.step(a_state, b)
    torch.cuda.synchronize()
    train_s["autotune_smoke"] = time.perf_counter() - t_at
    counts["autotune_smoke"] = read()
    a_counts = orch_t.decision_counts()
    a_over = orch_t.decide_overhead_s()
    if not (max(a_counts.values()) >= 20 and a_over < 0.1
            and math.isfinite(float(a_m["loss"]))):
        fail(f"autotuner: decisions {a_counts}, decide overhead {a_over} s")
    train_rows["autotune_smoke"] = dict(decisions=a_counts,
                                        decide_overhead_s=a_over,
                                        wall_s=train_s["autotune_smoke"])
    print(f"autotune_smoke (Qwen3-8B smoke, B=8, seq 64, 40 steps) on "
          f"{card}: decisions {a_counts}, decide overhead "
          f"{a_over * 1e3:.3f} ms a step, {train_s['autotune_smoke']:.3f} s "
          f"wall; launches {dict(zip(KERNELS, counts['autotune_smoke']))}")
    del a_state, a_batches

    # a killed and resumed checkpointed smoke run against an uninterrupted
    # one, with PyTorch's deterministic algorithms (the embedding's and the
    # loss's scatter-adds otherwise add in any order on the card)
    ck_train = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ck_train, ignore_errors=True)
    kcfg = smoke_config("qwen3-8b")
    k_args = dict(steps=6, batch=2, seq=16, ckpt_every=2, log_every=6,
                  device=dev)

    class Killed(Exception):
        pass

    real_step = lm_steps.make_train_step

    def dying(*a, **kw):
        step, calls = real_step(*a, **kw), [0]

        def run_(state, batch, *hooks):
            calls[0] += 1
            if calls[0] == 4:
                raise Killed()
            return step(state, batch, *hooks)
        return run_

    def final_ckpt(d):
        step = CheckpointManager(str(d)).latest_step()
        sd = d / f"step_{step:08d}"
        return step, {f.name: np.load(f) for f in sorted(sd.glob("*.npy"))}

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t_k = time.perf_counter()
        whole = lm_train.run(kcfg, ckpt_dir=str(ck_train / "whole"),
                             **k_args)["losses"]
        # the killed run writes its checkpoints before it goes on
        real_manager = lm_train.CheckpointManager
        lm_train.steps_lib.make_train_step = dying
        lm_train.CheckpointManager = lambda d, keep: real_manager(
            d, keep, async_write=False)
        try:
            lm_train.run(kcfg, ckpt_dir=str(ck_train / "cut"), **k_args)
            fail("checkpointed training: the run was not killed")
        except Killed:
            pass
        finally:
            lm_train.steps_lib.make_train_step = real_step
            lm_train.CheckpointManager = real_manager
        resumed = lm_train.run(kcfg, ckpt_dir=str(ck_train / "cut"),
                               resume=True, **k_args)
        torch.cuda.synchronize()
        train_s["ckpt_train"] = time.perf_counter() - t_k
        counts["ckpt_train"] = read()
    finally:
        torch.use_deterministic_algorithms(False)
    sa, fa_ck = final_ckpt(ck_train / "whole")
    sb, fb_ck = final_ckpt(ck_train / "cut")
    if not (resumed["start_step"] == 2 and resumed["losses"] == whole[2:]
            and sa == sb == 6 and sorted(fa_ck) == sorted(fb_ck)
            and all(np.array_equal(fa_ck[k], fb_ck[k]) for k in fa_ck)):
        fail(f"checkpointed training: the resumed run differs (losses "
             f"{resumed['losses']} vs {whole[2:]})")
    print(f"ckpt_train (Qwen3-8B smoke, 6 steps, checkpoints every 2, "
          f"killed in step 4, resumed from step 2; deterministic "
          f"algorithms) on {card}: losses and all {len(fa_ck)} checkpoint "
          f"leaves bitwise the uninterrupted run's; "
          f"{train_s['ckpt_train']:.3f} s wall")
    (ROOT / "chiprun_out" / "lm_training_port.json").write_text(json.dumps(
        {"card": card, "rows": train_rows, "grad_checks": grad_errs},
        indent=1))
    torch.cuda.empty_cache()

    # ---- 9z. the distributed layer: the probe of two ranks on one card,
    # then qwen2-vl-2b at full width through the (1, 1) mesh path ---------
    mesh_row = mesh_phase(torch, np, card, vl, train_rows["qwen2vl_train"],
                          lm_train, fa_ops, reset_counts, read, counts)
    train_s["qwen2vl_train_mesh_1x1"] = mesh_row["wall_s"]
    (ROOT / "chiprun_out" / "mesh_port.json").write_text(json.dumps(
        {"card": card, **mesh_row}, indent=1))
    torch.cuda.empty_cache()

    # ---- 9za. the dry-run: Qwen3-8B's cells traced on fake 256- and
    # 512-rank groups, and one more qwen2-vl-2b (1, 1) step counted on the
    # card against its fake trace ------------------------------------------
    dry_row = dryrun_phase(torch, card, vl, mesh_row["step_s"],
                           reset_counts, read, counts, fa_ops)
    train_s["qwen2vl_train_counted_1x1"] = dry_row["wall_s"]
    (ROOT / "chiprun_out" / "dryrun_port.json").write_text(json.dumps(
        dry_row, indent=1))

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
        cyc, chain = chain_numbers(packed)
        print(f"{shape} on {card}: kernel {ms:.4f} ms/launch, bound "
              f"{max(by, op):.6f} ms ({nbytes} bytes -> {by:.6f} ms; "
              f"{flops} f32 ops -> {op:.6f} ms), chain bound {chain:.4f} ms "
              f"({ns} dependent steps of {cyc:.1f} cycles); "
              f"{ms / ns * 1e3:.3f} us/step")
        return ms, max(by, op), by, op, chain

    def chain_numbers(packed):
        """(cycles a step, ms) of the episode's dependent chain
        (``kernel.chain_cycles``, counted from the source and priced at the
        latencies measured on this card type) at ``packed``'s shapes, times
        S over the SM clock read now; a launch with no ``qfun`` episode
        runs the table's chain."""
        args, kw = packed
        mlp = {}
        if "mlp_dims" in kw and bool((args[2][:, soc_ref.N_CONSTS] != 0)
                                     .any()):
            mlp = dict(mlp_dims=kw["mlp_dims"], mlp_feats=kw["mlp_feats"])
        cyc = soc_kernel.chain_cycles(kw["n_threads"], kw["n_tiles"],
                                      kw["n_actions"],
                                      ddr=kw.get("ddr_attribution", False),
                                      **mlp)
        return cyc, cyc * args[0].shape[1] / (sm_clock_mhz() * 1e3)

    serve_rows = {}

    def serve_numbers(packed, shape):
        """The same for the serve kernel: it reads footprint, u_explore,
        tiles, profile, avail, the gumbel and (faulted) the fault columns
        of xf (it makes eps, alpha and the n_accs-wide others block
        itself), acc_id and pre_mode of xi; per request four admission
        attempts over a queue_cap ring, the watchdog and the fused step.
        Its chain bound is ``kernel.serve_chain_cycles`` a request, times
        S over the SM clock; with ``--parent`` the parent commit's body
        runs on the same arguments in turns (parent, this, this, parent)
        after a check that the two bodies' outputs are bitwise equal."""
        (xf, xi, xv, consts, carry), kw = packed
        run = lambda: soc_kernel.soc_step_serve(xf, xi, xv, consts, carry,
                                                **kw)
        row = {"shape": shape}
        if parent_kernel is not None:
            old_run = lambda: parent_kernel.soc_step_serve(
                xf, xi, xv, consts, carry, **kw)
            (nc, ny), (oc, oy) = run(), old_run()
            if not (torch.equal(ny, oy) and same_carry(torch, nc, oc)):
                fail(f"{shape}: this serve body and the parent's differ")
            turns = [time_kernel(f) for f in (old_run, run, run, old_run)]
            ms = (turns[1] + turns[2]) / 2
            row.update(parent_ms=(turns[0] + turns[3]) / 2, turns=turns)
        else:
            ms = time_kernel(run)
        row["ms"] = ms
        mlp = {}
        if carry.wpack is not None and bool(
                (consts[:, soc_ref.N_SERVE_CONSTS] != 0).any()):
            mlp = dict(mlp_dims=kw["mlp_dims"], mlp_feats=kw["mlp_feats"])
        cyc = soc_kernel.serve_chain_cycles(
            s1.n_accs, s1.n_mem_tiles, kw["n_actions"],
            ddr=kw.get("ddr_attribution", False), **mlp)
        chain = cyc * xf.shape[1] / (sm_clock_mhz() * 1e3)
        row.update(chain_cycles=cyc, chain_ms=chain)
        if mlp:
            # the one-warp body's count: the admission, then the step with
            # its network, every piece in a row
            row["chain_cycles_one_warp"] = soc_kernel.chain_cycles(
                s1.n_accs, s1.n_mem_tiles, kw["n_actions"],
                ddr=kw.get("ddr_attribution", False), **mlp) + sum(
                    n * soc_kernel.LATENCY[k]
                    for k, n in soc_kernel.ADMISSION.items())
        serve_rows[shape] = row
        nb, ns, nf = xf.shape
        carry_bytes = sum(4 * t.numel() for t in carry if t is not None)
        nbytes = (4 * (nb * ns * ((nf - 2 - s1.n_accs) + 2 + xv.shape[-1]
                                  + len(soc_ref.SERVE_YCOLS))
                       + consts.numel()) + 2 * carry_bytes)
        n_qfun = (int((consts[:, soc_ref.N_SERVE_CONSTS] != 0).sum())
                  if carry.wpack is not None else 0)
        flops = (nb * ns * (4 * (fig11.QUEUE_CAP + 4) + 30 + 200
                            + s1.n_accs * (9 + 5 * s1.n_mem_tiles)
                            + (6 if kw["faulted"] else 0))
                 + (n_qfun * ns * mlp_step_ops(kw["mlp_dims"],
                                               kw["mlp_feats"])
                    if n_qfun else 0))
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_F32_FLOPS * 1e3
        print(f"{shape} on {card}: kernel {ms:.4f} ms/launch, bound "
              f"{max(by, op):.6f} ms ({nbytes} bytes -> {by:.6f} ms; "
              f"{flops} f32 ops -> {op:.6f} ms), chain bound {chain:.4f} ms "
              f"({ns} dependent requests of {cyc:.1f} cycles"
              + (f"; {row['chain_cycles_one_warp']:.1f} in a row, the "
                 "one-warp body's count" if mlp else "")
              + f"); {ms / ns * 1e3:.3f} us/request"
              + (f"; parent body {row['parent_ms']:.4f} ms (turns parent/"
                 "this/this/parent " + "/".join(f"{x:.4f}"
                                               for x in row["turns"])
                 + f"), {row['parent_ms'] / ms:.2f}x, outputs bitwise equal"
                 if "parent_ms" in row else ""))
        return ms, max(by, op), by, op, chain

    nums = [
        episode_numbers(packed_main, f"soc_step_episode B={b} S={s_len}"),
        serve_numbers(sv_packed, f"soc_step_serve B=4 S={n_req}"),
        episode_numbers(packed_f,
                        f"soc_step_episode_faulted B={b} S={s_len}"),
        serve_numbers(svf_packed, f"soc_step_serve_faulted B=4 S={n_req}"),
        episode_numbers(packed_m, f"soc_step_episode_mlp B={b} S={s_len}"),
        episode_numbers(packed_mf,
                        f"soc_step_episode_mlp_faulted B={b} S={s_len}"),
        serve_numbers(mlp_packed["soc_step_serve_mlp"],
                      f"soc_step_serve_mlp B=4 S={n_req}"),
        serve_numbers(mlp_packed["soc_step_serve_mlp_faulted"],
                      f"soc_step_serve_mlp_faulted B=4 S={n_req}"),
    ]
    mlp_light = serve_numbers(mlp_packed["0.2x"],
                              f"soc_step_serve_mlp B=4 S={n_req} at 0.2x "
                              "load (no watchdog)")
    # K2 on the same load, so that the network's share is measured
    sv_light = serve_numbers(sv_light_packed,
                             f"soc_step_serve B=4 S={n_req} at 0.2x load")
    plain = [ep_plain_ms, sv_plain_ms, epf_plain_ms, svf_plain_ms,
             epm_plain_ms, epmf_plain_ms, mlp_plain["2x"],
             mlp_plain["storm"]]
    errs = [ep_err, sv_err, epf_err, svf_err, epm_err, epmf_err, 0.0, 0.0]
    shapes = [f"B={b} S={s_len}", f"B=4 S={n_req}", f"B={b} S={s_len}",
              f"B=4 S={n_req}", f"B={b} S={s_len}", f"B={b} S={s_len}",
              f"B=4 S={n_req}", f"B=4 S={n_req}"]
    for name, ms in zip(SOC_KERNELS, plain):
        print(f"{name}: plain version {ms:.1f} ms on the same inputs; "
              f"library_ms null (no single PyTorch call computes the step)")

    def episode_at(name, path, label, packed):
        """ms a launch of the episode kernel on a path's recorded
        arguments, beside the chain bound and, with ``--parent``, the
        parent commit's body on the same arguments, timed in turns
        (parent, this, this, parent) after checking that the two bodies'
        outputs are bitwise equal."""
        args, kw = packed
        run = lambda: soc_kernel.soc_step_episode(*args, **kw)
        row = dict(path=path, shape=label, B=args[0].shape[0],
                   S=args[0].shape[1], T=kw["n_threads"],
                   n_tiles=kw["n_tiles"], ddr=kw.get("ddr_attribution",
                                                     False))
        if parent_kernel is not None:
            old_run = lambda: parent_kernel.soc_step_episode(*args, **kw)
            new_out, old_out = run(), old_run()
            if not all(torch.equal(a, r) for a, r in zip(new_out, old_out)):
                fail(f"{name} {label}: this body and the parent's differ")
            turns = [time_kernel(f) for f in (old_run, run, run, old_run)]
            row.update(ms=(turns[1] + turns[2]) / 2,
                       parent_ms=(turns[0] + turns[3]) / 2, turns=turns)
        else:
            row["ms"] = time_kernel(run)
        row["chain_cycles"], row["chain_ms"] = chain_numbers(packed)
        row["us_per_step"] = row["ms"] / row["S"] * 1e3
        print(f"{name} {path} {label} on {card}: {row['ms']:.4f} ms/launch "
              f"({row['us_per_step']:.3f} us/step), chain bound "
              f"{row['chain_ms']:.4f} ms ({row['chain_cycles']:.1f} cycles "
              f"a step)" + (f"; parent body {row['parent_ms']:.4f} ms "
                            f"(turns parent/this/this/parent "
                            + "/".join(f"{t:.4f}" for t in row["turns"])
                            + f"), {row['parent_ms'] / row['ms']:.2f}x, "
                            "outputs bitwise equal"
                            if parent_kernel is not None else ""))
        return row

    def recorded_at(path, name, pick_b, steps=lambda s: s > 1):
        """The recorded launch of ``path`` at the B that ``pick_b`` picks
        (min or max) from the recorded Bs whose S ``steps`` admits, the
        longest such S recorded there."""
        keys = [k for k in recorded if k[:2] == (path, name) and steps(k[3])]
        if not keys:
            fail(f"{path} recorded no {name} launch: {sorted(recorded)}")
        b_sel = pick_b(k[2] for k in keys)
        s_max = max(k[3] for k in keys if k[2] == b_sel)
        return f"B={b_sel} S={s_max}", recorded[(path, name, b_sel, s_max)]

    by_shape = {n: [] for n in SOC_KERNELS}
    k1, k1f, k1m, k1mf = (SOC_KERNELS[0], SOC_KERNELS[2], SOC_KERNELS[4],
                          SOC_KERNELS[5])
    by_shape[k1].append(episode_at(k1, "fig6", f"B={b} S={s_len}",
                                   packed_main))
    # Fig. 9: training, evaluation and the one-step profiling launches
    for pick_b, steps in ((min, lambda s: s > 1), (max, lambda s: s > 1),
                          (min, lambda s: s == 1)):
        by_shape[k1].append(episode_at(
            k1, "fig9", *recorded_at("fig9", k1, pick_b, steps)))
    by_shape[k1].append(episode_at(k1, "fig13",
                                   *recorded_at("fig13", k1, min)))
    # Fig. 12: the largest bucket's training (108 lanes) and evaluation
    # (108 x 7 episodes) launches
    for pick_b in (lambda bs: max(x for x in bs if x < 200), max):
        by_shape[k1].append(episode_at(k1, "fig12",
                                       *recorded_at("fig12", k1, pick_b)))
    by_shape[k1f].append(episode_at(k1f, "fig6 storm 1.0",
                                    f"B={b} S={s_len}", packed_f))
    by_shape[k1f].append(episode_at(k1f, "fig10",
                                    *recorded_at("fig10", k1f, max)))
    by_shape[k1m].append(episode_at(
        k1m, "fig6 (120 learning sense networks)", f"B={b} S={s_len}",
        packed_m))
    by_shape[k1m].append(episode_at(k1m, "fig13",
                                    *recorded_at("fig13", k1m, max)))
    by_shape[k1mf].append(episode_at(k1mf, "fig6 storm 1.0",
                                     f"B={b} S={s_len}", packed_mf))

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

    def attention_numbers(shape, q, k, v, causal, softcap=0.0):
        """(ms, plain ms, SDPA ms, bound ms, bytes ms, ops ms, device ms,
        SDPA device ms, body) of K3 on (q, k, v): ms from 20 launches in a
        row, as every kernel's (the wrapper's host work included where it
        is longer than the kernel), device ms from a CUDA graph of 20
        launches (the host's work left out); the bytes of q, k, v read
        once and the output written once; the operations of the (query,
        key) pairs the mask keeps (a multiply and an add per element of
        QK^T and of PV), at the bf16 tensor-core peak.  With ``softcap``
        SDPA, which has none, is timed without it as the nearest
        yardstick."""
        b, h, hkv, sq, skv, hd = shape
        feat = dict(causal=causal, softcap=softcap)
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
        """(ms, plain ms, bound ms, bytes ms, ops ms, FP64 vector floor
        ms, parent row) of K5 on the inputs the path gives it (a zero
        initial state passed in): r, k, v, logw, u and s0 read once, y
        and the final state written once; per chunk of 16 steps and head,
        the cumsum, the exponentials and their products (8 operations per
        element of the K-wide rows), the 120 strictly causal entries of A
        and their products with v, the bonus, q_t S and the state update,
        in float64: at the FP64 tensor-core peak for the bound, at the
        vector FP64 peak for the floor beside it.  With ``--parent`` the
        parent commit's body runs on the same inputs in turns (parent,
        this, this, parent) after a check that the two agree within the
        tolerance."""
        b, h, t, kd = shape
        run = lambda: rw_kernel.rwkv6_scan(r, k, v, lw, u, s0)
        prow = None
        if parent_rw is not None:
            old_run = lambda: parent_rw.rwkv6_scan(r, k, v, lw, u, s0)
            diff = max((a - o).abs().max().item()
                       for a, o in zip(run(), old_run()))
            if not diff <= TOL:
                fail(f"rwkv6_scan {shape}: this body and the parent's "
                     f"differ by {diff}")
            turns = [time_kernel(f) for f in (old_run, run, run, old_run)]
            ms = (turns[1] + turns[2]) / 2
            prow = dict(parent_ms=(turns[0] + turns[3]) / 2, turns=turns,
                        max_abs_diff=diff)
        else:
            ms = time_kernel(run)
        pl_ms = plain_ms(lambda: rw_ref.wkv_ref(r, k, v, lw, u, s0))
        c = rw_kernel.CHUNK
        pairs = c * (c - 1) // 2
        per_chunk = (8 * c * kd + pairs * 2 * kd + c * 3 * kd
                     + (pairs + c) * 2 * kd + c * 2 * kd * kd + c * kd
                     + kd * kd * (2 * c + 2))
        flops = b * h * (t // c) * per_chunk
        nbytes = 4 * (5 * b * h * t * kd + h * kd + 2 * b * h * kd * kd)
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_F64_TC_FLOPS * 1e3
        floor = flops / H100_F64_FLOPS * 1e3
        print(f"rwkv6_scan {shape} float32 on {card}: kernel {ms:.4f} "
              f"ms/launch ({nbytes / ms / 1e6:.1f} GB/s), plain "
              f"{pl_ms:.3f} ms; bound {max(by, op):.6f} ms ({nbytes} bytes "
              f"-> {by:.6f} ms; {flops} f64 ops -> {op:.6f} ms on the FP64 "
              f"tensor cores, {floor:.6f} ms at the vector FP64 rate); "
              f"library_ms null (no single PyTorch call computes the "
              f"recurrence)" + (
                  f"; parent body {prow['parent_ms']:.4f} ms (turns parent/"
                  "this/this/parent " + "/".join(f"{x:.4f}"
                                                for x in prow["turns"])
                  + f"), {prow['parent_ms'] / ms:.2f}x, outputs within "
                  f"{prow['max_abs_diff']:.3e}" if prow else ""))
        return ms, pl_ms, max(by, op), by, op, floor, prow

    rw_num = scan_numbers(RWKV_SCAN, *rw_in)

    def gmm_numbers(what, shape, sizes):
        """(ms, plain ms, cuBLAS ms, bound ms, bytes ms, ops ms, device ms,
        body, fp32_tiled ms, fp32_tiled device ms) of K4 in bf16 at
        ``shape`` with the path's group ``sizes`` (B, E): ms from 20
        launches in a row, as every kernel's, device ms from a CUDA graph
        of 20 launches; the CUDA-core body, ``fp32_tiled``, on the same
        inputs; the kept x rows read once, the weights of every expert
        that some batch row routes to read once, the whole output written
        once; two operations per kept row and weight, at the bf16
        tensor-core peak.  The library call is the dense batched product
        the reference computes, ``torch.matmul`` over the whole buffer
        (cuBLAS)."""
        b_, e, c, d, f = shape
        x = torch.randn(b_, e, c, d, generator=gmm_gen,
                        device=dev).to(torch.bfloat16)
        w = (torch.randn(e, d, f, generator=gmm_gen, device=dev)
             / d ** 0.5).to(torch.bfloat16)
        kern = lambda: gmm_kernel.moe_gmm(x, w, sizes)
        old = lambda: gmm_kernel.launch(x, w, sizes, body="fp32_tiled")
        body = gmm_kernel.launch(x, w, sizes)[1].body
        dev_ms, ms = graph_ms(kern), time_kernel(kern)
        old_dev_ms, old_ms = graph_ms(old), time_kernel(old)
        pl_ms = plain_ms(lambda: gmm_ref.gmm_ref(x, w, sizes))
        lib_ms = time_kernel(lambda: torch.matmul(x, w))
        rows = int(sizes.sum())
        experts = int((sizes.sum(0) > 0).sum())
        nbytes = 2 * (rows * d + experts * d * f + b_ * e * c * f)
        flops = 2 * rows * d * f
        by = nbytes / H100_BYTES_PER_S * 1e3
        op = flops / H100_BF16_FLOPS * 1e3
        print(f"moe_gmm {what} {shape} bf16 {body} on {card}: kernel "
              f"{ms:.4f} ms/launch (device {dev_ms:.4f} ms: "
              f"{flops / dev_ms / 1e9:.2f} TFLOP/s over {rows} kept rows, "
              f"{nbytes / dev_ms / 1e9:.3f} TB/s, {experts} experts' "
              f"weights), fp32_tiled {old_ms:.4f} ms (device "
              f"{old_dev_ms:.4f}), plain {pl_ms:.3f} ms, cuBLAS matmul "
              f"{lib_ms:.4f} ms; bound {max(by, op):.6f} ms ({nbytes} bytes "
              f"-> {by:.6f} ms; {flops} bf16 ops -> {op:.6f} ms)")
        return (ms, pl_ms, lib_ms, max(by, op), by, op, dev_ms, body,
                old_ms, old_dev_ms)

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
    fa_gm_pre = attention_numbers(FA_GM_PREFILL, *gm_fa["prefill"], True,
                                  GM_SOFTCAP)
    fa_gm_dec = attention_numbers(FA_GM_DECODE[:6], *gm_fa["decode"], True,
                                  GM_SOFTCAP)
    # the same prefill without the soft-cap, to see what the tanh costs
    fa_gm_nocap = attention_numbers(FA_GM_PREFILL, *gm_fa["prefill"], True)
    fa_vl_pre = attention_numbers(FA_VL_PREFILL, *new_fa["qwen2-vl"]["prefill"],
                                  True)
    fa_vl_dec = attention_numbers(FA_VL_DECODE[:6],
                                  *new_fa["qwen2-vl"]["decode"], True)
    fa_mg_pre = attention_numbers(FA_MG_PREFILL, *new_fa["musicgen"]["prefill"],
                                  True)
    fa_mg_dec = attention_numbers(FA_MG_DECODE[:6],
                                  *new_fa["musicgen"]["decode"], True)
    gmm_pre = gmm_numbers("prefill gate/up", GMM_PREFILL, gmm_sizes[0])
    gmm_down = gmm_numbers("prefill down", GMM_DOWN, gmm_sizes[0])
    gmm_dec = gmm_numbers("decode gate/up", GMM_DECODE, gmm_sizes[1])
    gmm_dec_down = gmm_numbers("decode down", gmm_down_dec, gmm_sizes[1])
    paths_s = {"fig6": fig6_s, "fig9": fig9_s, "fig11": fig11_s,
               "fig10": fig10_s, "fig10_des_xcheck": fig10x_s,
               "storm_serving": storm_s, "fig13": fig13_s,
               "qwen3_serve": qwen_s, "rwkv6_serve": rwkv_s,
               "granite_serve": granite_s, "recurrentgemma_serve": rgemma_s,
               "mlp_serving": mlp_serving_s, "gemma2_serve": gemma_s,
               "bf16_smoke_serve": bf16_smoke_s,
               "arctic_smoke_serve": arctic_smoke_s,
               "qwen2vl_serve": qwen2vl_s, "musicgen_serve": musicgen_s,
               "qwen3_int8_serve": qwen_int8_s,
               "qwen3_serve_beside_int8": qwen_again_s, **fid_s, **train_s,
               "des_vs_vecenv": des_vs_vec_s, **des_paths,
               **soc_layer_paths}
    print(f"paths on {card}: " + ", ".join(f"{p} {t:.3f} s"
                                           for p, t in paths_s.items()))

    # launches: the sum over the paths; main_path_s: the summed wall time
    # of the paths that launched the kernel
    by_path = lambda j: {p: c[j] for p, c in counts.items()}
    on_paths = lambda j: sum(paths_s[p] for p, c in counts.items() if c[j])
    kernels = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/soc_step/csrc/soc_step.cu",
         "replaces": ("src/repro/kernels/soc_step/ops.py:128"
                      if name.startswith("soc_step_serve_mlp")
                      else "src/repro/kernels/soc_step/kernel.py:258"
                      if "serve" in name
                      else "src/repro/kernels/soc_step/kernel.py:113"),
         "replaces_note": ("no TPU kernel: the reference serves MLP agents "
                           "in its XLA scan"
                           if name.startswith("soc_step_serve_mlp")
                           else "the Pallas kernel"),
         "variant": ("mlp_dims, " if "mlp" in name else "")
                    + ("faulted=True" if "faulted" in name else "healthy"),
         "launches": sum(c[KERNELS.index(name)] for c in counts.values()),
         "launches_by_path": by_path(KERNELS.index(name)),
         "max_abs_err": errs[j],
         "ms": nums[j][0], "plain_ms": plain[j], "bound_ms": nums[j][1],
         "bound_by": "bytes" if nums[j][2] >= nums[j][3] else "operations",
         "library_ms": None, "main_path_s": on_paths(KERNELS.index(name)),
         "shape": shapes[j], "chain_ms": nums[j][4],
         "by_shape": by_shape[name] or [serve_rows[f"{name} {shapes[j]}"]],
         "card": card}
        for j, name in enumerate(SOC_KERNELS)], "paths_s": paths_s}
    kernels["kernels"][SOC_KERNELS.index("soc_step_serve_mlp")].update(
        light_load_ms=mlp_light[0], light_load_chain_ms=mlp_light[4],
        light_load="0.2x Fig. 11's capacity: no watchdog, the network on "
                   "every admitted request of its two streams",
        light_load_k2_ms=sv_light[0])
    kernels["kernels"][SOC_KERNELS.index("soc_step_serve")].update(
        light_load_ms=sv_light[0], light_load_chain_ms=sv_light[4])
    j = KERNELS.index("flash_attention")
    bound_by = lambda n: "bytes" if n[4] >= n[5] else "operations"
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
        "gm_shape": f"prefill {FA_GM_PREFILL}, soft-cap {GM_SOFTCAP}",
        "gm_ms": fa_gm_pre[0], "gm_plain_ms": fa_gm_pre[1],
        "gm_bound_ms": fa_gm_pre[3], "gm_library_ms": fa_gm_pre[2],
        "gm_decode_shape": str(FA_GM_DECODE[:6]),
        "gm_decode_ms": fa_gm_dec[0], "gm_decode_plain_ms": fa_gm_dec[1],
        "gm_decode_bound_ms": fa_gm_dec[3],
        "gm_decode_library_ms": fa_gm_dec[2],
        "gm_library_note": "SDPA without the soft-cap (no PyTorch call "
                           "soft-caps attention)",
        "gm_no_softcap_ms": fa_gm_nocap[0],
        **{f"{tag}_{k}": v for tag, shape, dshape, pre, dec in (
            ("vl", FA_VL_PREFILL, FA_VL_DECODE[:6], fa_vl_pre, fa_vl_dec),
            ("mg", FA_MG_PREFILL, FA_MG_DECODE[:6], fa_mg_pre, fa_mg_dec))
           for k, v in (("shape", f"prefill {shape}"), ("ms", pre[0]),
                        ("plain_ms", pre[1]), ("bound_ms", pre[3]),
                        ("bound_by", bound_by(pre)),
                        ("library_ms", pre[2]),
                        ("decode_shape", str(dshape)),
                        ("decode_ms", dec[0]), ("decode_plain_ms", dec[1]),
                        ("decode_bound_ms", dec[3]),
                        ("decode_bound_by", bound_by(dec)),
                        ("decode_library_ms", dec[2]))},
        "timing": "ms: 20 launches in a row, as every kernel's; device_ms: "
                  "a CUDA graph of 20 launches replayed",
        "device_ms": {n: x[6] for n, x in (
            ("prefill", fa_pre), ("decode", fa_dec), ("rg", fa_rg_pre),
            ("rg_decode", fa_rg_dec), ("gr", fa_gr_pre),
            ("gr_decode", fa_gr_dec), ("gm", fa_gm_pre),
            ("gm_decode", fa_gm_dec), ("gm_no_softcap", fa_gm_nocap),
            ("vl", fa_vl_pre), ("vl_decode", fa_vl_dec),
            ("mg", fa_mg_pre), ("mg_decode", fa_mg_dec))},
        "library_device_ms": {n: x[7] for n, x in (
            ("prefill", fa_pre), ("decode", fa_dec), ("rg", fa_rg_pre),
            ("rg_decode", fa_rg_dec), ("gr", fa_gr_pre),
            ("gr_decode", fa_gr_dec), ("gm", fa_gm_pre),
            ("gm_decode", fa_gm_dec), ("vl", fa_vl_pre),
            ("vl_decode", fa_vl_dec), ("mg", fa_mg_pre),
            ("mg_decode", fa_mg_dec))},
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
        "fp64_floor_ms": rw_num[5], "parent": rw_num[6],
        "probe_cases_bitwise": rw_probes,
        "shape": f"(B, H, T, K) {RWKV_SCAN}", "card": card})
    j = KERNELS.index("moe_gmm")
    kernels["kernels"].append({
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:51",
        "variant": "bf16, B x E groups per launch: tc_gmm (wgmma, TMA) "
                   "and gemv_decode (clusters over D slices); float32 "
                   "through fp32_tiled",
        "launches": sum(c[j] for c in counts.values()),
        "launches_by_path": by_path(j),
        "max_abs_err": max(v for k, v in gmm_errs.items()
                           if k.endswith("bfloat16")),
        "max_abs_err_float32": gmm_errs["fp32_tiled float32"],
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
        "decode_library_ms": gmm_dec[2],
        "decode_down_shape": str(gmm_down_dec),
        "decode_down_ms": gmm_dec_down[0],
        "decode_down_plain_ms": gmm_dec_down[1],
        "decode_down_bound_ms": gmm_dec_down[3],
        "decode_down_bound_by": bound_by(gmm_dec_down),
        "decode_down_library_ms": gmm_dec_down[2],
        "timing": "ms: 20 launches in a row, as every kernel's; device_ms: "
                  "a CUDA graph of 20 launches replayed",
        "body": {n: x[7] for n, x in (
            ("prefill", gmm_pre), ("down", gmm_down), ("decode", gmm_dec),
            ("decode_down", gmm_dec_down))},
        "device_ms": {n: x[6] for n, x in (
            ("prefill", gmm_pre), ("down", gmm_down), ("decode", gmm_dec),
            ("decode_down", gmm_dec_down))},
        "fp32_tiled_ms": {n: x[8] for n, x in (
            ("prefill", gmm_pre), ("down", gmm_down), ("decode", gmm_dec),
            ("decode_down", gmm_dec_down))},
        "fp32_tiled_device_ms": {n: x[9] for n, x in (
            ("prefill", gmm_pre), ("down", gmm_down), ("decode", gmm_dec),
            ("decode_down", gmm_dec_down))},
        "bodies_by_path": {"granite_serve": gmm_bodies},
        "max_abs_err_by_body": gmm_errs, "max_bf16_ulps_by_body": gmm_ulps,
        "probe_exact": gmm_probes, "hgmma": gmm_hgmma, "card": card})
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
        if k["name"] in TRAIN_KERNELS:
            j = KERNELS.index(k["name"])
            k["training_launches"] = sum(counts[p][j] for p in train_s)
            k["training_launches_by_path"] = {p: counts[p][j]
                                              for p in train_s}
            k["backward"] = ("autodiff of the plain version, recomputed "
                             "from the saved inputs (no backward kernel)")
            k["grad_check"] = grad_errs[k["name"]]
            if k["training_launches"] == 0:
                fail(f"{k['name']}: no launch on the training paths")
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
