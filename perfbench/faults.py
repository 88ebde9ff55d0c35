"""The timed path broken on purpose, to show that ``correct`` catches it.

    python3 perfbench/faults.py --workload <cell> --fault <fault> \
        --seeds 1,2,3 [--seconds 1]

runs the cell at its own size on the card with the step kernel's
entry (``repro_torch.kernels.soc_step.ops.fused_episode``) replaced, and
prints each run's numbers beside their limits.  The faults:

  * ``control``: the reference's own step loop in bfloat16 state
    (:mod:`perfbench.reference.control`) in the kernel's place;
  * ``unchanged``: the launch returns its input state unchanged;
  * ``half``: half of the batch left out, its rows a copy of the rest;
  * ``altered``: one answer of every episode altered where it is
    produced (its first execution time doubled).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

FAULTS = ("control", "unchanged", "half", "altered")


def _half(t: torch.Tensor) -> torch.Tensor:
    """The first half of the rows, repeated over the second half."""
    h = (t.shape[0] + 1) // 2
    return torch.cat([t[:h], t[:t.shape[0] - h]])


def episode_fault(fault: str, inner):
    """A replacement of ``fused_episode``."""
    from perfbench.reference import control

    def broken(s, learned, weights, qtable0, extrema0, xs, **kw):
        if fault == "control":
            return control.episode_lowp(s, learned, weights, qtable0,
                                        extrema0, xs, **kw)
        out = inner(s, learned, weights, qtable0, extrema0, xs, **kw)
        state, ys = list(out[:-1]), list(out[-1])
        if fault == "unchanged":
            state = [qtable0.clone()]
        elif fault == "half":
            state, ys = [_half(v) for v in state], [_half(y) for y in ys]
        elif fault == "altered":
            ys[3] = ys[3].clone()
            ys[3][:, 0] *= 2.0
        return (*state, tuple(ys))

    return broken


def install(run, fault: str):
    """Replace the step entries for this run (``run.restore`` undoes it)."""
    from repro_torch.kernels.soc_step import ops
    run.patch(ops, "fused_episode", episode_fault(fault, ops.fused_episode))


def main(argv=None) -> int:
    import argparse
    from perfbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, args.workload, seed, args.seconds, False)
        run.warm = False        # no timing is read: the first unit suffices
        install(run, args.fault)
        res = harness.execute(run)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": res["correct"],
                          "units": len(run.units),
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    sys.exit(main())
