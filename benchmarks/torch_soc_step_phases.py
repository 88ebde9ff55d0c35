"""Where one step of the soc_step episode kernel (K1, K1m) spends its
cycles, and what the operations on its dependent chain cost, on the card.

    PYTHONPATH=src:. python -m benchmarks.torch_soc_step_phases \
        [--tree DIR] [--mlp] [--latency] [--vs DIR2]
    PYTHONPATH=src:. python -m benchmarks.torch_soc_step_phases \
        --serve [--tree DIR ...]
    PYTHONPATH=src:. python -m benchmarks.torch_soc_step_phases \
        --serve --mlp [--tree DIR] [--vs DIR2]

Builds ``DIR/src/repro_torch/kernels/soc_step/csrc/soc_step.cu`` (default:
this checkout's) with ``-DSOC_STEP_PHASES``, which turns on the source's
``clock64()`` stamps: lane 0 adds the cycles between consecutive stamps
into one counter per phase of the step.  A source without stamps (the
body before the Hopper redesign, unpacked with ``git archive``) gets them
inserted at the anchors in :data:`PARENT_STAMPS` first.  The build is a
scratch build under ``build/repro_torch/``; the committed kernel never
has the stamps.  It then runs the episode kernel once at Fig. 6's shape
(``SOC_MOTIV_PAR``, B = 120 learning agents, a 540-step app; ``--mlp``:
120 learning sense networks through K1m) through ``DIR``'s own
``kernel.py`` and prints the cycles per step of each phase.

``--latency`` builds ``benchmarks/csrc/soc_step_latency.cu`` (which
includes this checkout's kernel source) and prints the cycles of each
operation on the step's chain (float add, multiply, IEEE division, the
kernel's ``qdiv``, ``xla_log`` and ``tmin``, a shared-memory load,
``__shfl_sync``, a shared-memory store and load across ``__syncwarp``),
the numbers that
``kernel.chain_cycles`` prices the chain with.  Prints the card's name,
power limit and SM clock beside them.  ``--vs DIR2`` also times
``DIR2``'s and ``DIR``'s own kernels (no stamps) at the same shape, in
turns (DIR2, DIR, DIR, DIR2), and says whether their outputs are bitwise
equal.

``--serve`` splits a request of the serve kernel (K2) instead: it runs
Fig. 11's path once (``benchmarks/torch_fig11_serving.py``) with the
serve wrapper recording its arguments, takes the 2x-load launch (B = 4
policies, 1,024 requests), and runs each ``--tree``'s serve kernel on it
with stamps on; a serve kernel without stamps of its own (the body
before its redesign) gets them at the anchors of
:data:`PARENT_SERVE_STAMPS`.  It prints the cycles a request of row
staging, admission, the fused step (``step_warp``, by its own phases)
and the bookkeeping with the trace stores.  Needs a CUDA card.

``--serve --mlp`` splits a request of K2m instead, on the learning
network's stream at Fig. 11's 0.2x load (the watchdog never trips, so
the network runs on every admitted request): it builds the MLP serving
path's four policies as ``chip_smoke.py`` does (a Q-table trained as Fig.
11 trains it, a (14, 16, 16, 4) sense network trained through K1m for as
many iterations, the frozen copy, the table and NON_COH with
placeholders), records the 0.2x launch (B = 4, 1,024 requests) and runs
the learning stream alone (B = 1) through each tree's stamped kernel.  A
one-warp body (before the network warp) gets :data:`PARENT_MLP_STAMPS`
(room for 20 counters, a stamp between the features and the forward);
the two-warp body stamps each warp's phases itself.  It prints each
warp's split (admission, the step side, features, forward, selection and
pick, TD update, the handoff waits) and, with ``--vs DIR``, times DIR's
and the tree's kernels on the whole B = 4 launch in turns (DIR, tree,
tree, DIR) after checking their outputs bitwise equal.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core import qlearn, rewards
from repro_torch.kernels import nvcc
from repro_torch.kernels.soc_step import ref as soc_ref
from repro_torch.soc import apps, nn as socnn, vecenv as vec
from repro_torch.soc.config import SOC_MOTIV_PAR

ROOT = Path(__file__).resolve().parents[1]
REL_SOURCE = Path("src/repro_torch/kernels/soc_step/csrc/soc_step.cu")
REL_KERNEL = Path("src/repro_torch/kernels/soc_step/kernel.py")
WEIGHTS = [
    (0.675, 0.075, 0.25), (0.125, 0.125, 0.75), (1.0, 0.0, 0.0),
    (0.0, 0.0, 1.0), (0.05, 0.05, 0.90), (0.33, 0.33, 0.34),
    (0.5, 0.25, 0.25), (0.25, 0.5, 0.25), (0.8, 0.1, 0.1),
    (0.1, 0.8, 0.1), (0.45, 0.1, 0.45), (0.6, 0.0, 0.4),
    (0.9, 0.05, 0.05), (0.2, 0.2, 0.6), (0.4, 0.4, 0.2),
]
N_SEEDS, ITERS, N_PHASES, SEED = 8, 10, 6, 11
LAT_NAMES = ("f32 add", "f32 multiply", "IEEE division", "xla_log", "tmin",
             "shared load", "__shfl_sync", "store + __syncwarp + load",
             "qdiv (branch-free division)")
BLOCK_NAMES = ("timing, four modes (qdiv)", "timing, four modes (IEEE /)",
               "reward, four modes (qdiv)", "selection",
               "MLP forward (14, 16, 16, 4)", "MLP TD update (14, 16, 16, 4)")

# The stamp machinery, shared by both bodies: lane 0 adds the cycles since
# the previous stamp to phase k's counter; the block's counters go to a
# device array at the end, summed over blocks.
STAMP_DEFS = r"""
#ifdef SOC_STEP_PHASES
namespace {
constexpr int N_PH = 12;
__device__ unsigned long long g_phase_cycles[N_PH];
__shared__ long long ph_acc[N_PH];
__shared__ long long ph_last;
}
#define PH_INIT() do { if (threadIdx.x == 0) { \
  for (int k_ = 0; k_ < N_PH; ++k_) ph_acc[k_] = 0; ph_last = clock64(); } \
  __syncwarp(); } while (0)
#define PH(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \
  ph_acc[k] += t_ - ph_last; ph_last = t_; } } while (0)
#define PH_FLUSH() do { if (threadIdx.x == 0) for (int k_ = 0; k_ < N_PH; \
  ++k_) atomicAdd(&g_phase_cycles[k_], (unsigned long long)ph_acc[k_]); \
  } while (0)
extern "C" int soc_step_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                       N_PH * sizeof(unsigned long long));
  if (reset) {
    unsigned long long z[N_PH] = {};
    cudaMemcpyToSymbol(g_phase_cycles, z, sizeof z);
  }
  return (int)e;
}
#endif
"""

# (anchor in the body before the redesign, text put in front of it)
PARENT_STAMPS = [
    ("namespace {\n\nconstexpr int MAX_T", STAMP_DEFS + "\n"),
    ("    warm_t = x.fresh ? 1.0f : self_row[TBL_WARM];", "    PH(1);\n"),
    ("  if constexpr (MLP) {\n    __syncwarp();\n    mlp_forward_warp",
     "  PH(2);\n"),
    ("    if (lead && m->qfun != 0.0f) {", "    PH(3);\n"),
    ("    const int mode =\n        ((x.avail[action]", "    PH(4);\n"),
    ("    // ---- reward input: true or DDR-attributed", "    PH(5);\n"),
    ("    // ---- reward: rewards.evaluate with the extrema update",
     "    PH(6);\n"),
    ("    // ---- learn + bookkeeping", "    PH(7);\n"),
    ("  if constexpr (MLP)\n    mlp_td_update_warp", "  PH(8);\n"),
    ("}\n\n// The MLP's static shape", "  PH(9);\n"),
    ("    for (int j = lane; j < nf; j += 32) xrow[j] = xf_b[(size_t)i * nf"
     " + j];\n    if (lane < 5) irow[lane] = xi_b[(size_t)i * 5 + lane];\n"
     "    __syncwarp();\n    if (MLP", "    PH(10);\n"),
    ("    if (MLP || lane == 0) {   // the MLP step uses the whole warp",
     "    PH(0);\n"),
    ("  float* qo = qtable_out + (size_t)b * nq;", "  PH_FLUSH();\n"),
    ("  float* q = smem;                   // n_states * A",
     "  PH_INIT();\n"),
]
PARENT_PHASES = ("row load (global, after the previous step)",
                 "masked read + observe (lane 0)",
                 "Q-row read, warmth, MLP features (lane 0)",
                 "MLP forward (warp)", "selection (lane 0)",
                 "timing: invocation_perf_cached (lane 0)",
                 "DDR attribution (lane 0)", "reward + extrema (lane 0)",
                 "writes: Q, extrema, slot row (lane 0)",
                 "MLP TD update (warp)", "y store + __syncwarp",
                 "(unused)")
# (anchor in the serve kernel before its redesign, stamp put after it):
# row staging ends at the rows' __syncwarp, admission at lane 0's
# hand-over, the bookkeeping at the request's last __syncwarp; the fused
# step's own stamps (1-9) split the step
PARENT_SERVE_STAMPS = [
    ("    if (lane < 3) vrow[lane] = xv_b[(size_t)i * 3 + lane];\n"
     "    __syncwarp();\n", "    PH(0);\n"),
    ("      y_b[(size_t)i * N_SERVE_Y + 9] = depth0;\n    }\n"
     "    __syncwarp();\n", "    PH(11);\n"),
    ("      yr[12] = finish * ex_f;\n    }\n    __syncwarp();\n",
     "    PH(10);\n"),
    ("  const float* sp = c + N_CONSTS;\n", "  PH_INIT();\n"),
    ("  for (int i = lane; i < nq; i += 32) q_out[(size_t)b * nq + i] = "
     "q[i];\n", None),
]
# a one-warp MLP serve body (before the network warp): room for 20
# counters and a stamp between the features and the forward
PARENT_MLP_STAMPS = [
    ("constexpr int N_PH = 12;", "constexpr int N_PH = 20;"),
    ("      __syncwarp();\n      mlp_forward_warp(m, lane);\n",
     "      PH(12);\n      __syncwarp();\n      mlp_forward_warp(m, lane);\n"),
]
N_PH_MAX = 20
# each body's K2m split, by warp: (name, counters)
MLP_SPLIT_ONE_WARP = {"one warp": (
    ("row staging + y flush", (0,)), ("admission", (11,)),
    ("step side (step_pre)", (1, 2, 3, 4, 5)),
    ("Q-row read + features (lane 0)", (12,)), ("forward", (6,)),
    ("selection and pick", (7,)), ("writes", (8,)),
    ("TD update", (9,)), ("bookkeeping + trace row", (10,)))}
MLP_SPLIT_TWO_WARPS = {
    "step warp": (
        ("row staging + y flush", (0,)), ("admission", (11,)),
        ("step side (step_pre)", (1, 2, 3, 4, 5)),
        ("handoff: wait for the network warp to take the inputs "
         "(its TD update of the request before)", (6,)),
        ("handoff: wait for the Q-row (features + forward)", (18,)),
        ("selection and pick", (7,)), ("writes", (8,)),
        ("handoff: publish the action and reward", (9,)),
        ("bookkeeping + trace row", (10,))),
    "network warp": (
        ("handoff: wait for the row (the step warp's admission)", (12,)),
        ("row features (lanes 0-2, 10-13: the logs, four divisions)",
         (17,)),
        ("handoff: wait for the step's inputs (the step side)", (19,)),
        ("step features (lanes 3-9)", (13,)),
        ("forward", (14,)),
        ("handoff: wait for the action (selection and pick)", (15,)),
        ("TD update", (16,)))}
SERVE_GROUPS = (("row staging", (0,)), ("admission", (11,)),
                ("step_warp", tuple(range(1, 10))),
                ("bookkeeping + trace stores", (10,)))
# the phases of the redesigned body, in its PH() order
NEW_PHASES = ("ring: wait for the staged rows",
              "per-slot terms (lane t)", "ordered sums (lane j)",
              "observe + the four modes' timings",
              "DDR attribution (four modes)", "reward (four modes)",
              "Q-row, MLP features + forward (warp)",
              "selection + picking shuffles", "writes",
              "MLP TD update (warp) + __syncwarp",
              "y flush (a chunk's end)", "(unused)")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi",
         "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def stamped_source(tree: Path) -> tuple[Path, tuple]:
    """The source of ``tree`` with its stamps on, and its phase names."""
    text = (tree / REL_SOURCE).read_text()
    if "SOC_STEP_PHASES" in text:
        return tree / REL_SOURCE, NEW_PHASES
    for anchor, stamp in PARENT_STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {tree / REL_SOURCE}:"
                             f" {anchor!r}")
        text = text.replace(anchor, stamp + anchor)
    out = nvcc.BUILD_ROOT / "soc_step_phases_src" / "soc_step.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out, PARENT_PHASES


def stamped_serve_source(tree: Path) -> Path:
    """``tree``'s source with the serve kernel's stamps on (inserted at
    :data:`PARENT_SERVE_STAMPS` where its serve kernel has none)."""
    source, _ = stamped_source(tree)
    text = source.read_text()
    if "PH(11)" in text:
        return source
    for anchor, stamp in PARENT_SERVE_STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {source}: "
                             f"{anchor!r}")
        text = text.replace(anchor, anchor + stamp if stamp is not None
                            else "  PH_FLUSH();\n" + anchor)
    out = nvcc.BUILD_ROOT / "soc_step_serve_phases_src" / "soc_step.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def stamped_mlp_serve_source(tree: Path, i: int) -> tuple[Path, dict]:
    """``tree``'s source with K2m's stamps on, and its split by warp
    (``i`` names the scratch copy)."""
    source = stamped_serve_source(tree)
    text = source.read_text()
    if "PH(13)" in text:
        return source, MLP_SPLIT_TWO_WARPS
    for anchor, repl in PARENT_MLP_STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {source}: "
                             f"{anchor!r}")
        text = text.replace(anchor, repl)
    out = (nvcc.BUILD_ROOT / f"soc_step_mlp_serve_phases_src_{i}"
           / "soc_step.cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out, MLP_SPLIT_ONE_WARP


def fig11_mlp_serve_launch(dev, mult: float = 0.2):
    """The arguments of the MLP serving path's launch at ``mult`` x Fig.
    11's capacity (B = 4: the learning network, its frozen copy, a
    Q-table and NON_COH, 1,024 requests), built as ``chip_smoke.py``'s
    phase 9r builds them (``torch_fig11_serving.mlp_serving_policies``
    and ``load_traffic``, on the capacity ``run_port`` calibrates)."""
    from benchmarks import torch_fig11_serving as fig11
    from repro_torch.kernels.soc_step import kernel as this_kernel
    from repro_torch.soc.config import SOCS
    cap = fig11.run_port(dev)["_capacity"]
    soc = SOCS[fig11.SOC_NAME]
    env = vec.VecEnv(soc, seed=1, device=dev)
    app = vec.compile_app(apps.make_application(soc, seed=50,
                                                n_phases=fig11.N_PHASES),
                          soc, seed=4)
    n_req = fig11.N_REQUESTS
    _, specs, cfg = fig11.mlp_serving_policies(env, app, n_req)
    seen = []
    inner = this_kernel.soc_step_serve

    def record(*args, **kw):
        seen.append((args, kw))
        return inner(*args, **kw)

    this_kernel.soc_step_serve = record
    try:
        vec.ServeEnv(env, queue_cap=fig11.QUEUE_CAP, n_requests=n_req
                     ).serve_specs(app, specs,
                                   fig11.load_traffic(mult, cap, device=dev),
                                   cfg=cfg)
    finally:
        this_kernel.soc_step_serve = inner
    return seen[-1]


def serve_mlp_phases(trees, reps: int = 5) -> list:
    """Cycles a request of each tree's K2m on the learning network's
    stream at Fig. 11's 0.2x load, by warp and phase; with two trees,
    both kernels timed on the whole B = 4 launch in turns."""
    from repro_torch.kernels.soc_step import kernel as this_kernel
    args, kw = fig11_mlp_serve_launch(torch.device("cuda"))
    one = lambda t: t[:1].contiguous()
    args1 = (*(one(a) for a in args[:4]), args[4].map(one))
    s = args[0].shape[1]
    out = []
    for i, tree in enumerate(trees):
        source, split = stamped_mlp_serve_source(tree, i)
        lib_path = nvcc.build(source, f"soc_step_mlp_serve_phases_{i}",
                              this_kernel.NVCC_FLAGS + ("-DSOC_STEP_PHASES",))
        mod = load_kernel_module(tree, lib_path)
        lib = mod._load()
        lib.soc_step_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * N_PH_MAX)()
        mod.soc_step_serve(*args1, **kw)
        torch.cuda.synchronize()
        lib.soc_step_phase_cycles(buf, 1)
        _, y = mod.soc_step_serve(*args1, **kw)
        torch.cuda.synchronize()
        if lib.soc_step_phase_cycles(buf, 1) != 0:
            raise SystemExit("reading the phase counters failed")
        per_req = [v / s for v in buf]
        served = int(y[0, :, 6].sum())
        row = {"tree": str(tree), "S": s, "served": served,
               "card": card_line(), "warps": {}}
        print(f"K2m phases, {tree}: the learning network's stream (B=1, "
              f"S={s}, {served} admitted, Fig. 11's 0.2x load) on "
              f"{row['card']}:")
        for warp, phases_ in split.items():
            split_w = {n: sum(per_req[k] for k in ks) for n, ks in phases_}
            total = sum(split_w.values())
            row["warps"][warp] = {"phases": split_w, "total": total}
            print(f"  {warp}:")
            for n, c in split_w.items():
                print(f"    {n:72s} {c:9.1f} cycles/request "
                      f"({100 * c / total:5.1f}%)")
            print(f"    {'total':72s} {total:9.1f} cycles/request")
        out.append(row)
    if len(trees) == 2:
        mods = []
        for i, tree in enumerate(trees):
            spec = importlib.util.spec_from_file_location(
                f"soc_step_kernel_mlp_plain_{i}", tree / REL_KERNEL)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods.append(mod)
        outs = [m.soc_step_serve(*args, **kw) for m in mods]
        torch.cuda.synchronize()
        flat = lambda o: [t for t in (*o[0], o[1]) if t is not None]
        same = all(torch.equal(x, y)
                   for x, y in zip(flat(outs[0]), flat(outs[1])))
        times = {str(t): [] for t in trees}
        for j in (0, 1, 1, 0):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
            for _ in range(reps):
                mods[j].soc_step_serve(*args, **kw)
            ev1.record()
            torch.cuda.synchronize()
            times[str(trees[j])].append(ev0.elapsed_time(ev1) / reps)
        print(f"K2m at Fig. 11's 0.2x launch (B=4, S={s}) on {card_line()}, "
              "ms a launch in turns: " + "; ".join(
                  f"{t}: {v}" for t, v in times.items())
              + f"; outputs bitwise equal: {same}")
        out.append({"ms": times, "bitwise_equal": same})
    return out


def fig11_serve_launch(dev):
    """The arguments of Fig. 11's serve launch at 2x load (B = 4
    policies, 1,024 requests), recorded from one run of the path."""
    from benchmarks import torch_fig11_serving as fig11
    from repro_torch.kernels.soc_step import kernel as this_kernel
    seen = []
    inner = this_kernel.soc_step_serve

    def record(*args, **kw):
        seen.append((args, kw))
        return inner(*args, **kw)

    this_kernel.soc_step_serve = record
    try:
        fig11.run_port(dev)
    finally:
        this_kernel.soc_step_serve = inner
    # two calibration launches, then one a load of fig11.LOADS
    return seen[2 + fig11.LOADS.index(2.0)]


def serve_phases(trees, reps: int = 5) -> list:
    """Cycles a request of each tree's serve kernel, by phase, at Fig.
    11's 2x-load launch, and its unstamped time in turns (first tree,
    second, second, first)."""
    from repro_torch.kernels.soc_step import kernel as this_kernel
    args, kw = fig11_serve_launch(torch.device("cuda"))
    b, s = args[0].shape[:2]
    out = []
    for i, tree in enumerate(trees):
        lib_path = nvcc.build(stamped_serve_source(tree),
                              f"soc_step_serve_phases_{i}",
                              this_kernel.NVCC_FLAGS + ("-DSOC_STEP_PHASES",))
        mod = load_kernel_module(tree, lib_path)
        lib = mod._load()
        lib.soc_step_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * N_PH_MAX)()
        mod.soc_step_serve(*args, **kw)
        torch.cuda.synchronize()
        lib.soc_step_phase_cycles(buf, 1)
        mod.soc_step_serve(*args, **kw)
        torch.cuda.synchronize()
        if lib.soc_step_phase_cycles(buf, 1) != 0:
            raise SystemExit("reading the phase counters failed")
        per_req = [v / (b * s) for v in buf]
        row = {"tree": str(tree), "B": b, "S": s, "card": card_line(),
               "cycles_per_request": sum(per_req),
               "groups": {g: sum(per_req[k] for k in ks)
                          for g, ks in SERVE_GROUPS},
               "step_phases": {NEW_PHASES[k]: per_req[k]
                               for k in range(1, 10)}}
        print(f"K2 phases, {tree} at B={b} S={s} (Fig. 11, 2x load) on "
              f"{row['card']}:")
        for g, c in row["groups"].items():
            print(f"  {g:44s} {c:9.1f} cycles/request "
                  f"({100 * c / row['cycles_per_request']:5.1f}%)")
        for n, c in row["step_phases"].items():
            print(f"    step: {n:38s} {c:9.1f}")
        print(f"  {'total':44s} {row['cycles_per_request']:9.1f} "
              "cycles/request")
        out.append(row)
    mods = []
    for i, tree in enumerate(trees):
        spec = importlib.util.spec_from_file_location(
            f"soc_step_kernel_serve_plain_{i}", tree / REL_KERNEL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    outs = [m.soc_step_serve(*args, **kw) for m in mods]
    torch.cuda.synchronize()
    flat = lambda o: [*o[0], o[1]]
    same = all(all(torch.equal(x, y) for x, y in zip(flat(o), flat(outs[0])))
               for o in outs)
    times = {str(t): [] for t in trees}
    for j in (0, 1, 1, 0) if len(mods) == 2 else (0, 0):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps):
            mods[j].soc_step_serve(*args, **kw)
        ev1.record()
        torch.cuda.synchronize()
        times[str(trees[j])].append(ev0.elapsed_time(ev1) / reps)
    print(f"K2 at Fig. 11's 2x launch on {card_line()}, ms a launch in "
          "turns: " + "; ".join(f"{t}: {v}" for t, v in times.items())
          + f"; outputs bitwise equal: {same}")
    out.append({"ms": times, "bitwise_equal": same})
    return out


def load_kernel_module(tree: Path, lib_path: Path):
    """``tree``'s ``kernel.py`` as a module of its own, bound to the
    stamped library."""
    spec = importlib.util.spec_from_file_location(
        f"soc_step_kernel_{abs(hash(str(tree)))}", tree / REL_KERNEL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = lambda verbose=False: lib_path
    mod._lib = None
    return mod


def fig6_inputs(dev, mlp: bool):
    """The packed arguments of one Fig. 6 training launch (B = 120)."""
    soc = SOC_MOTIV_PAR
    env = vec.VecEnv(soc, device=dev)
    app = apps.make_application(soc, seed=SEED, n_phases=N_PHASES)
    compiled = vec.compile_app(app, soc, seed=SEED)
    sched = compiled.schedule.to(dev)
    b = len(WEIGHTS) * N_SEEDS
    cfg = qlearn.QConfig(decay_steps=compiled.n_steps * ITERS)
    grid = [(w, s) for w in WEIGHTS for s in range(N_SEEDS)]
    wb = rewards.stack_weights([w for w, _ in grid], device=dev)
    keys = prng.PRNGKey(np.asarray([SEED + 100003 * s for _, s in grid],
                                   np.uint32), device=dev)
    if mlp:
        spec = vec.mlp_policy_spec(socnn.init_mlp_qstate(keys), sched)
    else:
        spec = vec.learned_policy_spec(qlearn.init_qstate_batch(cfg, b, dev),
                                       sched)
    xs, _ = vec.episode_inputs(env.params, sched, spec, cfg, keys)
    xf, xi = soc_ref.pack_inputs(xs)
    extra = () if spec.mlp is None else (spec.qfun, spec.mlp.lr)
    consts = soc_ref.pack_consts(env.static, spec.learned, wb, b, dev, *extra)
    ex0 = rewards.init_reward_state(soc.n_accs, (b,), dev).extrema
    args = [xf, xi, consts, spec.qstate.qtable.contiguous(), ex0]
    kw = dict(n_threads=xs.others.shape[-1], n_tiles=xs.tiles.shape[-1],
              n_actions=4)
    if spec.mlp is not None:
        args.append(spec.mlp.wpack.contiguous())
        kw.update(mlp_dims=socnn.mlp_dims(spec.mlp.cfg),
                  mlp_feats=spec.mlp.cfg.features)
    return args, kw


def phases(tree: Path, mlp: bool) -> dict:
    source, names = stamped_source(tree)
    from repro_torch.kernels.soc_step import kernel as this_kernel
    lib_path = nvcc.build(source, "soc_step_phases",
                          this_kernel.NVCC_FLAGS + ("-DSOC_STEP_PHASES",))
    mod = load_kernel_module(tree, lib_path)
    args, kw = fig6_inputs(torch.device("cuda"), mlp)
    lib = mod._load()
    lib.soc_step_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * N_PH_MAX)()
    mod.soc_step_episode(*args, **kw)
    torch.cuda.synchronize()
    lib.soc_step_phase_cycles(buf, 1)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    mod.soc_step_episode(*args, **kw)
    ev1.record()
    torch.cuda.synchronize()
    if lib.soc_step_phase_cycles(buf, 1) != 0:
        raise SystemExit("reading the phase counters failed")
    b, s = args[0].shape[:2]
    per_step = [v / (b * s) for v in buf]
    total = sum(per_step)
    out = {"tree": str(tree), "mlp": mlp, "B": b, "S": s,
           "stamped_ms": ev0.elapsed_time(ev1), "card": card_line(),
           "cycles_per_step": total,
           "phases": {n: c for n, c in zip(names, per_step) if c}}
    print(f"{'K1m' if mlp else 'K1'} phases, {tree} at B={b} S={s} on "
          f"{out['card']} (stamped build {out['stamped_ms']:.3f} ms):")
    for n, c in out["phases"].items():
        print(f"  {n:48s} {c:9.1f} cycles/step ({100 * c / total:5.1f}%)")
    out["implied_sm_mhz"] = total * s / (out["stamped_ms"] * 1e3)
    print(f"  {'total':48s} {total:9.1f} cycles/step (the stamped launch "
          f"implies {out['implied_sm_mhz']:.0f} MHz)")
    return out


def compare(trees, mlp: bool, reps: int = 5) -> dict:
    """ms a launch of each tree's own (unstamped) kernel at Fig. 6's
    shape, timed in turns (first, second, second, first)."""
    mods = []
    for tree in trees:
        spec = importlib.util.spec_from_file_location(
            f"soc_step_kernel_plain_{len(mods)}", tree / REL_KERNEL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    args, kw = fig6_inputs(torch.device("cuda"), mlp)
    outs = [mod.soc_step_episode(*args, **kw) for mod in mods]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    times = {str(t): [] for t in trees}
    for j in (0, 1, 1, 0) if len(mods) == 2 else (0, 0):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps):
            mods[j].soc_step_episode(*args, **kw)
        ev1.record()
        torch.cuda.synchronize()
        times[str(trees[j])].append(ev0.elapsed_time(ev1) / reps)
    print(f"{'K1m' if mlp else 'K1'} at Fig. 6's shape on {card_line()}, "
          f"ms a launch in turns: "
          + "; ".join(f"{t}: {v}" for t, v in times.items())
          + f"; outputs bitwise equal: {same}")
    return {"ms": times, "bitwise_equal": same}


def latency() -> dict:
    src = ROOT / "benchmarks" / "csrc" / "soc_step_latency.cu"
    from repro_torch.kernels.soc_step import kernel as this_kernel
    # key the build on the kernel source the benchmark includes, too
    text = src.read_text() + this_kernel.SOURCE.read_text()
    copy = nvcc.BUILD_ROOT / "soc_step_latency_src" / str(
        abs(hash(text))) / "soc_step_latency.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(src.read_text().replace(
        '"../../src/repro_torch/kernels/soc_step/csrc/soc_step.cu"',
        f'"{this_kernel.SOURCE}"'))
    lib = ctypes.CDLL(str(nvcc.build(copy, "soc_step_latency",
                                      this_kernel.NVCC_FLAGS)))
    out = (ctypes.c_longlong * len(LAT_NAMES))()
    n = ctypes.c_int()
    if lib.soc_step_latency(out, ctypes.byref(n)) != 0:
        raise SystemExit("latency kernel failed")
    res = {name: out[i] / n.value for i, name in enumerate(LAT_NAMES)}
    print(f"latencies on {card_line()} (cycles, {n.value} dependent "
          f"operations each):")
    for name, c in res.items():
        print(f"  {name:28s} {c:7.2f}")
    # the step's building blocks on a real row: Fig. 6's first agent, step
    # 100 of its training episode
    args, kw = fig6_inputs(torch.device("cuda"), False)
    xf, consts = args[0], args[2]
    row = xf[0, 100].cpu().numpy().astype("float32")
    crow = consts[0].cpu().numpy().astype("float32")
    n_tiles, T = kw["n_tiles"], kw["n_threads"]
    F = row.size - 4 - n_tiles - T - 12
    blocks = (ctypes.c_longlong * len(BLOCK_NAMES))()
    fp = ctypes.POINTER(ctypes.c_float)
    if lib.soc_step_block_latency(
            crow.ctypes.data_as(fp),
            row.ctypes.data_as(fp), crow.size, row.size, n_tiles, T, F,
            blocks, ctypes.byref(n)) != 0:
        raise SystemExit("block latency kernel failed")
    print(f"building blocks of the step (cycles a call, {n.value} "
          f"dependent calls, one warp):")
    for i, name in enumerate(BLOCK_NAMES):
        res[name] = blocks[i] / n.value
        print(f"  {name:40s} {res[name]:9.1f}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append")
    ap.add_argument("--serve", action="store_true",
                    help="split a request of the serve kernel instead")
    ap.add_argument("--mlp", action="store_true")
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--vs", help="a second tree whose kernel is timed "
                    "in turns with --tree's (no stamps)")
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    trees = [Path(t).resolve() for t in (a.tree or [str(ROOT)])]
    if a.serve and a.mlp:
        if a.vs:
            trees = [Path(a.vs).resolve(), trees[0]]
        res = {"serve_mlp": serve_mlp_phases(trees)}
        if a.out:
            Path(a.out).write_text(json.dumps(res, indent=1))
        return
    if a.serve:
        res = {"serve": serve_phases(trees)}
        if a.out:
            Path(a.out).write_text(json.dumps(res, indent=1))
        return
    res = {"phases": phases(trees[0], a.mlp)}
    if a.vs:
        res["compare"] = compare([Path(a.vs).resolve(), trees[0]], a.mlp)
    if a.latency:
        res["latency"] = latency()
    if a.out:
        Path(a.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    sys.exit(main())
