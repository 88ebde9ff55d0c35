"""Whether two runs of a figure script gave the same results.

    python -m benchmarks.torch_same_results A.json B.json [C.json ...]

Compares the JSON files that ``benchmarks/torch_fig{9_socs,10_faults,
13_generalize}.py --out`` (or ``chip_smoke.py``) write, key by key, leaving
out ``_engine`` (wall times, launch counts).  Numbers must be equal
exactly, not within a tolerance: a change to a kernel's speed must not
move a result.  Prints each differing path with both values and exits 1
when any differs; with more than two files, each is held against the
first.
"""
from __future__ import annotations

import json
import sys

SKIP = ("_engine",)


def differences(a, b, path: str = ""):
    """Paths at which ``a`` and ``b`` differ, with both values."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            if k in SKIP:
                continue
            if k not in a or k not in b:
                out.append((f"{path}/{k}", a.get(k), b.get(k)))
            else:
                out += differences(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [(path, f"{len(a)} items", f"{len(b)} items")]
        out = []
        for i, (u, v) in enumerate(zip(a, b)):
            out += differences(u, v, f"{path}[{i}]")
        return out
    return [] if a == b else [(path, a, b)]


def main(argv=None) -> int:
    files = (sys.argv[1:] if argv is None else argv)
    if len(files) < 2:
        print(__doc__)
        return 2
    first = json.loads(open(files[0]).read())
    bad = 0
    for other in files[1:]:
        diff = differences(first, json.loads(open(other).read()))
        print(f"{files[0]} vs {other}: "
              + ("equal in every result field" if not diff
                 else f"{len(diff)} differing fields"))
        for p, u, v in diff[:20]:
            print(f"  {p}: {u!r} vs {v!r}")
        bad += bool(diff)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
