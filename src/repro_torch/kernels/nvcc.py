"""Build a CUDA source of the port into a shared library on first use.

Each kernel's ``csrc/*.cu`` has a plain C interface and is compiled with
``nvcc`` (no PyTorch headers, so a build takes seconds) into
``build/repro_torch/<name>-<hash of source and flags>/lib<name>.so`` at
the root of the checkout, then loaded with ``ctypes``.  A missing
``nvcc`` raises: there is no fallback.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SM90A = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source on first use")


def build(source: Path, name: str, flags: tuple,
          verbose: bool = False) -> Path:
    """Compile ``source`` with ``flags`` (if this source, the headers
    beside it and these flags have not been built yet) and return the
    shared library's path; with ``verbose`` print what ``-Xptxas -v`` says
    of each kernel."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    out_dir = BUILD_ROOT / f"{name}-{digest[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib.name
        cmd = [find_nvcc(), *flags, "-Xptxas", "-v", "-o", str(tmp_lib),
               str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp_lib, lib)
    return lib
