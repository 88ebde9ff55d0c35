"""Where the jitted JAX reference fuses multiply-adds (ROADMAP C1).

    PYTHONPATH=src python -m benchmarks.torch_c1_fma_sites [--out DIR]

XLA on the CPU contracts ``a*b + c`` into one fused multiply-add when the
multiply and the add land in one fusion and the host has FMA; the port
rounds each operation.  This script compiles three reference programs on
the CPU with the optimized HLO dumped (``--xla_dump_to``): the jitted
``episode_ref`` (table variant, ``gated`` off and on), the ServeEnv chunk
(``serve_episode_ref`` inside ``build_serve_fn``) and the vmapped episode
of ``StackedVecEnv.episodes``.  For each it lists the float32
multiply -> add/subtract pairs inside one fusion, by the source lines of
the two operations, and prints where the lists differ.  The same port
cannot match programs whose lists differ.  It also reports, for each
ISA limit, the share of jitted ``a*b + c`` results equal to a single
rounding.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from benchmarks.torch_no_fma import NO_FMA

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parents[1] / "tests"

PROGRAMS = {
    "episode": """
from test_soc_step_kernel import _soc_step_case
from repro.kernels.soc_step import ref as R
args, _ = _soc_step_case(True)
jax.block_until_ready(jax.jit(lambda *a: R.episode_ref(*a))(*args))
""",
    "episode_gated": """
from test_soc_step_kernel import _soc_step_case
from repro.kernels.soc_step import ref as R
args, _ = _soc_step_case(True)
jax.block_until_ready(jax.jit(lambda *a: R.episode_ref(*a, gated=True))(
    *args))
""",
    "serve": """
from repro.core import qlearn
from repro.soc import traffic, vecenv
from repro.soc.apps import make_application
from repro.soc.config import SOCS
soc = SOCS["SoC1"]
env = vecenv.VecEnv(soc, seed=1)
app = vecenv.compile_app(make_application(soc, seed=50, n_phases=2), soc,
                         seed=4)
spec = env.lower(app, "q", qstate=qlearn.init_qstate(qlearn.QConfig()))
se = vecenv.ServeEnv(env, queue_cap=8, n_requests=64)
jax.block_until_ready(se.serve(app, spec, traffic.bursty(1e-4, seed=3)))
""",
    "stacked": """
from repro.core.policies import QPolicy
from repro.soc.apps import make_application
from repro.soc.config import SOCS
from repro.soc.stacked import StackedVecEnv
socs = [SOCS["SoC1"], SOCS["SoC2"]]
env = StackedVecEnv(socs, seed=1)
st = env.compile([make_application(s, seed=50, n_phases=2) for s in socs],
                 seed=4)
jax.block_until_ready(env.episodes(st, env.lower(st, [QPolicy()])))
""",
}
MAIN_MODULE = {"episode": "jit__lambda", "episode_gated": "jit__lambda",
               "serve": "jit_serve", "stacked": "jit_one"}


def _frames(text: str) -> dict:
    """stack_frame_id -> 'file:line' of the frame's own location."""
    sec, names, locs, frames = None, {}, {}, {}
    for line in text.splitlines():
        s = line.strip()
        if s in ("FileNames", "FunctionNames", "FileLocations",
                 "StackFrames"):
            sec = s
            continue
        if not s:
            sec = None
            continue
        key = s.split(" ", 1)[0]
        if sec == "FileNames":
            path = s.split(" ", 1)[1].strip('"')
            names[key] = path.split("/src/")[-1].split("/tests/")[-1]
        elif sec == "FileLocations":
            m = re.search(r"file_name_id=(\d+).*? line=(\d+)", s)
            locs[key] = f"{names[m.group(1)]}:{m.group(2)}"
        elif sec == "StackFrames":
            m = re.search(r"file_location_id=(\d+)", s)
            frames[key] = locs[m.group(1)]
    return frames


def contraction_sites(hlo_text: str) -> collections.Counter:
    """(multiply's line, add's line) -> count over f32 multiply -> add or
    subtract pairs inside one fused computation."""
    frames = _frames(hlo_text)
    comps, cur = {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head and not line.startswith(" "):
            cur = head.group(1)
            comps[cur] = {}
            continue
        m = re.match(r"\s*(?:ROOT )?%([\w.\-]+) = (\S+) ([\w\-]+)\((.*?)\)"
                     r"(.*)$", line)
        if cur and m:
            name, shape, op, args, rest = m.groups()
            sf = re.search(r"stack_frame_id=(\d+)", rest)
            comps[cur][name] = (shape, op, re.findall(r"%([\w.\-]+)", args),
                                frames.get(sf.group(1), "?") if sf else "?")
    sites = collections.Counter()
    for cname, ops in comps.items():
        if "fus" not in cname:
            continue
        for shape, op, args, where in ops.values():
            if op not in ("add", "subtract") or not shape.startswith("f32"):
                continue
            for a in args:
                if a in ops and ops[a][1] == "multiply" \
                        and ops[a][0].startswith("f32"):
                    sites[(ops[a][3], where)] += 1
    return sites


def dump(name: str, out: Path, xla_flags: str = "") -> str:
    d = out / name
    env_flags = f"--xla_dump_to={d} --xla_dump_hlo_as_text {xla_flags}"
    code = "import jax\n" + PROGRAMS[name]
    env = {"XLA_FLAGS": env_flags, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": f"{SRC}:{TESTS}", "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=str(TESTS))
    files = sorted(d.glob(f"module_*.{MAIN_MODULE[name]}."
                          "cpu_after_optimizations.txt"))
    return files[-1].read_text()


def fma_share(xla_flags: str) -> str:
    code = ("import jax, numpy as np\n"
            "rng = np.random.default_rng(0)\n"
            "a, b, c = (rng.uniform(0.1, 3.0, 100000).astype(np.float32)"
            " for _ in range(3))\n"
            "r = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))\n"
            "one = (a.astype(np.float64) * b + c).astype(np.float32)\n"
            "print(f'{np.mean(r == one):.4f}')\n")
    env = {"XLA_FLAGS": xla_flags, "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-c", code], env=env, check=True,
                          capture_output=True, text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        lists = {}
        for name in PROGRAMS:
            lists[name] = contraction_sites(dump(name, out))
            print(f"== {name}: {sum(lists[name].values())} pairs, "
                  f"{len(lists[name])} distinct (multiply line, add line)")
            for (mul, add), n in sorted(lists[name].items()):
                print(f"   {mul} -> {add}  x{n}")
    first = "episode"
    for name in PROGRAMS:
        if name == first:
            continue
        a, b = set(lists[first]), set(lists[name])
        print(f"{first} vs {name}: only in {first}: {sorted(a - b)}; "
              f"only in {name}: {sorted(b - a)}")
    for flags in ("", NO_FMA):
        print(f"XLA_FLAGS={flags!r}: jitted a*b+c equals one rounding on "
              f"{fma_share(flags)} of 100000 inputs")


if __name__ == "__main__":
    main()
