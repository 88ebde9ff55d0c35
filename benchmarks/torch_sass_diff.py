"""Whether two checkouts compile the soc_step kernels to the same machine
code, kernel by kernel.

    PYTHONPATH=src python -m benchmarks.torch_sass_diff OLD_DIR [NEW_DIR]

Builds ``DIR/src/repro_torch/kernels/soc_step/csrc/soc_step.cu`` of both
checkouts (``NEW_DIR`` defaults to this one) with this checkout's
``kernel.NVCC_FLAGS``, disassembles each library with ``cuobjdump
-sass`` and prints, for every kernel entry point, its instruction count
in each build and whether the two listings are equal once addresses and
encodings are stripped.  Equal listings run the same instructions, so a
time difference between them is run-to-run spread.  Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit); no card.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import nvcc
from repro_torch.kernels.soc_step import kernel

REL_SOURCE = Path("src/repro_torch/kernels/soc_step/csrc/soc_step.cu")


# the per-build hash in the names of a file's anonymous namespace
_BUILD_HASH = re.compile(r"(__N__|_INTERNAL_)[0-9a-f]{8}_")
_KERNEL = re.compile(r"\d+(soc_step_\w+?_kernel|qdiv_probe_kernel)"
                     r"(?:I((?:Lb[01]E)+)E)?")


def short_name(mangled: str) -> str:
    """``kernel<FAULTED, MLP[, more flags]>``: flags past the first two
    are shown only if one is true, so an instantiation whose added flags
    are all false keeps the name of the one without them."""
    m = _KERNEL.search(mangled)
    if m is None:
        return mangled
    flags = re.findall(r"Lb([01])E", m.group(2) or "")
    if "1" not in flags[2:]:
        flags = flags[:2]
    return f"{m.group(1)}<{', '.join(flags)}>" if flags else m.group(1)


def listings(lib: Path) -> dict:
    """Each kernel's SASS instructions, addresses, encodings and the
    build's namespace hash dropped, by :func:`short_name`."""
    tool = Path(nvcc.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        line = _BUILD_HASH.sub(r"\1", line)
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = short_name(m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            funcs[name].append(m.group(1))
    return funcs


def main() -> None:
    if not 2 <= len(sys.argv) <= 3:
        raise SystemExit("usage: python -m benchmarks.torch_sass_diff "
                         "OLD_DIR [NEW_DIR]")
    trees = [Path(sys.argv[1]).resolve(),
             Path(sys.argv[2] if len(sys.argv) == 3 else ".").resolve()]
    libs = [nvcc.build(t / REL_SOURCE, f"soc_step_sass_{i}",
                       kernel.NVCC_FLAGS) for i, t in enumerate(trees)]
    old, new = (listings(lib) for lib in libs)
    print(f"soc_step kernels, {trees[0]} -> {trees[1]}:")
    for name in sorted(set(old) | set(new)):
        a, b = old.get(name), new.get(name)
        state = ("only in the new build" if a is None
                 else "only in the old build" if b is None
                 else "identical" if a == b else "different")
        print(f"  {name}: {len(a or ())} -> {len(b or ())} instructions, "
              f"{state}")


if __name__ == "__main__":
    main()
