"""The reference built without fused multiply-add (ROADMAP C1).

On an FMA host XLA contracts ``a*b + c`` inside its CPU fusions, and which
pairs it contracts depends on the fusion.  Capping the ISA at AVX, which
has no FMA, makes the jitted reference round each multiply and each add,
as the port does.  XLA reads ``XLA_FLAGS`` once, when jax starts, so the
flag is set before jax is first imported or handed to a fresh process.
"""
from __future__ import annotations

import os
import sys

NO_FMA = "--xla_cpu_max_isa=AVX"


def without_fma(flags: str = "") -> str:
    """``flags`` (an ``XLA_FLAGS`` value) with the ISA capped at AVX."""
    return f"{flags} {NO_FMA}".strip()


def use_reference_without_fma() -> None:
    """Build this process's reference without FMA; call it before jax is
    imported."""
    if "jax" in sys.modules:
        raise RuntimeError(f"jax is already imported: {NO_FMA} would be "
                           "ignored")
    os.environ["XLA_FLAGS"] = without_fma(os.environ.get("XLA_FLAGS", ""))
