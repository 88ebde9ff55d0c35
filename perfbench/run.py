"""Run one cell of the port's benchmark on the CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether the
timed path's outputs agree with the plain reference (``correct``), the
work attempted, the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), and the device; the numbers compared
with their limits come last there and as the last lines of standard
error.  Without a CUDA card it prints no result and exits with 3.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    sys.exit(harness.main())
