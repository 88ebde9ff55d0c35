"""Where a chunk of the RWKV-6 scan kernel (K5) spends its cycles, on the
card, at the rwkv6-3b prefill's shape.

    PYTHONPATH=src:. python -m benchmarks.torch_rwkv6_scan_phases \
        [--tree DIR ...] [--shape B H T K] [--out FILE]

For each ``DIR`` (default: this checkout; a ``git archive`` of another
commit works too) it builds ``DIR/src/repro_torch/kernels/rwkv6_scan/
csrc/rwkv6_scan.cu`` with ``-DRWKV6_SCAN_PHASES``, which turns on
``clock64()`` stamps: thread 0 of every block adds the cycles between
consecutive stamps to one counter per phase, and the counters are summed
over blocks.  A source without stamps (the body before the Hopper
redesign) gets them inserted at the anchors of :data:`PARENT_STAMPS`
first: row loads, cumsum, factors, A and the bonus, y, the state update,
each ending at the barrier after it.  The build is a scratch build under
``build/repro_torch/``; the committed kernel never has the stamps.  It
then runs that tree's own ``kernel.py`` on r, k, v (N(0, 1)), logw
(``max(-exp(N(0, 0.25)), -4)``), u and a random state at (B, H, T, K) =
(4, 40, 2048, 64) and prints the cycles of each phase per chunk and block,
beside the stamped launch's time and the card's name, power limit and SM
clock.  With two ``--tree``s it also times each tree's own (unstamped)
kernel on the same inputs in turns (first, second, second, first) and
prints the largest difference between their outputs.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

ROOT = Path(__file__).resolve().parents[1]
REL = Path("src/repro_torch/kernels/rwkv6_scan")
N_PH = 8
SHAPE = (4, 40, 2048, 64)

STAMP_DEFS = r"""
#ifdef RWKV6_SCAN_PHASES
namespace {
constexpr int N_PH = 8;
__device__ unsigned long long g_phase_cycles[N_PH];
}
#define PH_INIT() long long ph_acc_[N_PH] = {}; long long ph_last_ = clock64()
#define PH(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \
  ph_acc_[k] += t_ - ph_last_; ph_last_ = t_; } } while (0)
#define PH_FLUSH() do { if (threadIdx.x == 0) for (int k_ = 0; k_ < N_PH; \
  ++k_) atomicAdd(&g_phase_cycles[k_], (unsigned long long)ph_acc_[k_]); \
  } while (0)
extern "C" int rwkv6_scan_phase_cycles(unsigned long long* out, int reset) {
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

# (anchor in the PR 16 body, text, True: put after the anchor)
PARENT_STAMPS = [
    ("namespace {\n\nconstexpr int CHUNK", STAMP_DEFS + "\n", False),
    ("  // (t, s) of A and (t, column) of y: one entry per thread",
     "  PH_INIT();\n", False),
    ("    if (tid < K)\n      for (int i = 1; i < CHUNK; ++i)",
     "    PH(0);\n", False),
    ("    // q_t = r e^{cum - logw} (the exclusive cumsum)", "    PH(1);\n",
     False),
    ("    {\n      double a = 0.0;", "    PH(2);\n", False),
    ("    {\n      double intra = 0.0;", "    PH(3);\n", False),
    ("    // S = diag(e^{cum_end}) (S + k_in^T v)", "    PH(4);\n", False),
    ("      ss[kk][j] = exp(sc[CHUNK - 1][kk]) * (ss[kk][j] + delta);\n"
     "    }\n    __syncthreads();\n", "    PH(5);\n", True),
    ("  for (int e = tid; e < K * VT; e += NT) {\n"
     "    const int kk = e / VT, j = e % VT;\n    sp[kk * K + j]",
     "  PH_FLUSH();\n", False),
]
PARENT_PHASES = ("row loads (global, synchronous)", "cumsum (K threads)",
                 "factors: 2 x 16 x K double exp", "A and the bonus",
                 "y: intra + q S", "state update (16 exp a column)",
                 "(unused)", "(unused)")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi",
         "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def stamped_source(tree: Path):
    """The source of ``tree`` with its stamps on, and its phase names (a
    source with stamps of its own names them in a ``// phases:`` line)."""
    src = tree / REL / "csrc" / "rwkv6_scan.cu"
    text = src.read_text()
    if "RWKV6_SCAN_PHASES" in text:
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("// phases: "))
        names = tuple(n.strip() for n in line[len("// phases: "):]
                      .split(";"))
        return src, names + ("(unused)",) * (N_PH - len(names))
    for anchor, stamp, after in PARENT_STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {src}: {anchor!r}")
        text = text.replace(anchor, anchor + stamp if after
                            else stamp + anchor)
    out = nvcc.BUILD_ROOT / "rwkv6_scan_phases_src" / "rwkv6_scan.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out, PARENT_PHASES


def load_kernel(tree: Path, lib_path: Path | None, tag: str):
    """``tree``'s ``kernel.py`` as a module of its own; bound to
    ``lib_path`` when given (else it builds its own source)."""
    spec = importlib.util.spec_from_file_location(
        f"rwkv6_scan_kernel_{tag}", tree / REL / "kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if lib_path is not None:
        mod.build = lambda verbose=False: lib_path
        mod._lib = None
    return mod


def inputs(shape, seed=0):
    b, h, t, k = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    lw = torch.clamp(-torch.exp(0.5 * mk(b, h, t, k)), min=-4.0)
    return (mk(b, h, t, k), mk(b, h, t, k), mk(b, h, t, k), lw, mk(h, k),
            mk(b, h, k, k))


def phases(tree: Path, shape, tag: str) -> dict:
    source, names = stamped_source(tree)
    mod = load_kernel(tree, None, tag)
    lib_path = nvcc.build(source, f"rwkv6_scan_phases_{tag}",
                          mod.NVCC_FLAGS + ("-DRWKV6_SCAN_PHASES",))
    mod = load_kernel(tree, lib_path, tag + "_stamped")
    args = inputs(shape)
    lib = mod._load()
    lib.rwkv6_scan_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * N_PH)()
    mod.rwkv6_scan(*args)
    torch.cuda.synchronize()
    lib.rwkv6_scan_phase_cycles(buf, 1)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    mod.rwkv6_scan(*args)
    ev1.record()
    torch.cuda.synchronize()
    if lib.rwkv6_scan_phase_cycles(buf, 1) != 0:
        raise SystemExit("reading the phase counters failed")
    b, h, t, k = shape
    # blocks: the tree's own grid (the PR 16 body runs K / 16 column tiles
    # of each head, the redesign one block a head)
    n_blocks = b * h * getattr(mod, "BLOCKS_PER_HEAD", k // 16)
    per_chunk = [v / (n_blocks * (t // 16)) for v in buf]
    total = sum(per_chunk)
    out = {"tree": str(tree), "shape": list(shape), "blocks": n_blocks,
           "stamped_ms": ev0.elapsed_time(ev1), "card": card_line(),
           "cycles_per_chunk": total,
           "phases": {n: c for n, c in zip(names, per_chunk) if c}}
    print(f"K5 phases, {tree} at (B, H, T, K) = {shape}, {n_blocks} blocks "
          f"on {out['card']} (stamped build {out['stamped_ms']:.4f} ms):")
    for n, c in out["phases"].items():
        print(f"  {n:44s} {c:9.1f} cycles/chunk ({100 * c / total:5.1f}%)")
    print(f"  {'total':44s} {total:9.1f} cycles/chunk and block")
    return out


def compare(trees, shape, reps: int = 20) -> dict:
    """ms a launch of each tree's own kernel, in turns, and the largest
    difference between the two trees' outputs."""
    mods = [load_kernel(t, None, f"plain_{i}") for i, t in enumerate(trees)]
    args = inputs(shape)
    outs = [m.rwkv6_scan(*args) for m in mods]
    torch.cuda.synchronize()
    diff = max((a - b).abs().max().item()
               for a, b in zip(outs[0], outs[1]))
    times = {str(t): [] for t in trees}
    for j in (0, 1, 1, 0):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps):
            mods[j].rwkv6_scan(*args)
        ev1.record()
        torch.cuda.synchronize()
        times[str(trees[j])].append(ev0.elapsed_time(ev1) / reps)
    print(f"K5 at {shape} on {card_line()}, ms a launch in turns: "
          + "; ".join(f"{t}: {v}" for t, v in times.items())
          + f"; largest difference between the outputs {diff:.3e}")
    return {"ms": times, "max_abs_diff": diff}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append")
    ap.add_argument("--shape", type=int, nargs=4, default=list(SHAPE))
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    trees = [Path(t).resolve() for t in (a.tree or [str(ROOT)])]
    res = [phases(t, tuple(a.shape), str(i)) for i, t in enumerate(trees)]
    if len(trees) == 2:
        res.append(compare(trees, tuple(a.shape)))
    if a.out:
        Path(a.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    sys.exit(main())
