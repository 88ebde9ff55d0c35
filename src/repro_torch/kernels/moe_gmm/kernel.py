"""ctypes wrapper of the CUDA ``moe_gmm`` kernels.

``csrc/moe_gmm.cu`` (with the shared ``kernels/csrc/hopper.cuh``) is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
entry point per body, on first use (never at import), into
``build/repro_torch/moe_gmm-<hash>/`` at the root of the checkout
(:mod:`repro_torch.kernels.nvcc`).  A missing ``nvcc`` raises: there is no
fallback.

:func:`plan` names the body a call takes, from the shapes and the type
alone (it never reads the group sizes, so it never waits for the card),
and :func:`launch` calls that body's entry point:

* ``tc_gmm``: bf16 with more than :data:`DECODE_ROWS` rows a group, D and
  F multiples of 8 (TMA's 16-byte strides); a wgmma GEMM over the ragged
  groups, its tiles fed by TMA;
* ``gemv_decode``: bf16 with at most :data:`DECODE_ROWS` rows a group, as
  at decode, D and F multiples of 8; each live expert's weights streamed
  once by a cluster of blocks over D slices (:attr:`Plan.splits`);
* ``fp32_tiled``: everything else (float32, which tensor cores would round
  to TF32; unaligned bf16 shapes), on CUDA cores in float32.

The source's notes say what bounds each body and how it is laid out.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
NVCC_FLAGS = nvcc.SM90A
BODIES = ("tc_gmm", "gemv_decode", "fp32_tiled")
DECODE_ROWS = 16          # rows a group holds at most for gemv_decode
# gemv_decode cuts D into a power of two of slices (a thread block cluster,
# at most MAX_SPLITS), each at least MIN_SPLIT_ROWS rows of D
MAX_SPLITS = 8
MIN_SPLIT_ROWS = 256

_lib = None


class Plan(NamedTuple):
    """The body a call takes; for ``gemv_decode``, the number of D slices
    whose partial sums one cluster adds."""
    body: str
    splits: int = 1


def decode_splits(d: int) -> int:
    """The largest power of two <= :data:`MAX_SPLITS` that leaves every
    slice of ``d`` at least :data:`MIN_SPLIT_ROWS` rows (1 for short D)."""
    splits = 1
    while splits < MAX_SPLITS and d >= 2 * splits * MIN_SPLIT_ROWS:
        splits *= 2
    return splits


def plan(x_shape, w_shape, dtype: torch.dtype) -> Plan:
    """The body for x ``(..., E, C, D)`` against w ``(E, D, F)`` of
    ``dtype``."""
    c, d = x_shape[-2], x_shape[-1]
    f = w_shape[-1]
    if dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f % 8 == 0:
        if c <= DECODE_ROWS:
            return Plan("gemv_decode", decode_splits(d))
        return Plan("tc_gmm")
    return Plan("fp32_tiled")


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source has not been built yet) and
    return the shared library's path."""
    return nvcc.build(SOURCE, "moe_gmm", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.moe_gmm_fp32_tiled_launch.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.moe_gmm_tc_launch.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.moe_gmm_gemv_launch.argtypes = [p] * 4 + [i] * 6 + [p]
        for fn in (lib.moe_gmm_fp32_tiled_launch, lib.moe_gmm_tc_launch,
                   lib.moe_gmm_gemv_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, w, group_sizes):
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device});"
                             " CPU tensors take the plain version via ops")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({x.device, w.device, group_sizes.device}) != 1:
        raise ValueError("x, w and group_sizes lie on several devices")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if x.dim() not in (3, 4) or w.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} must be 3-D or 4-D and w "
                         f"{tuple(w.shape)} 3-D")
    *lead, e, c, d = x.shape
    if w.shape[:2] != (e, d):
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if tuple(group_sizes.shape) != (*lead, e):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != "
                         f"{(*lead, e)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its data is 16-byte aligned (TMA and the 16-byte
    loads need it), else a copy, which is."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
           body: str | None = None) -> tuple[torch.Tensor, Plan]:
    """:func:`moe_gmm`'s output and the :class:`Plan` it ran.  ``body =
    "fp32_tiled"`` runs that body in place of the plan's (it takes every
    call), to time one body against another on the same inputs; any other
    body the plan does not name raises."""
    _check(x, w, group_sizes)
    *lead, e, c, d = x.shape
    f = w.shape[2]
    p = plan(x.shape, w.shape, x.dtype)
    if body is not None and body != p.body:
        if body != "fp32_tiled":
            raise ValueError(f"{body} cannot take this call; its plan is "
                             f"{p.body}")
        p = Plan(body)
    out = torch.empty((*lead, e, c, f), dtype=x.dtype, device=x.device)
    g = group_sizes.numel()
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.body == "fp32_tiled":
            err = lib.moe_gmm_fp32_tiled_launch(
                x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                out.data_ptr(), int(x.dtype == torch.bfloat16), g, e, c, d,
                f, stream)
        else:
            x, w = _aligned(x), _aligned(w)
            if p.body == "tc_gmm":
                err = lib.moe_gmm_tc_launch(
                    x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                    out.data_ptr(), g, e, c, d, f, stream)
            else:
                err = lib.moe_gmm_gemv_launch(
                    x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                    out.data_ptr(), g, e, c, d, f, p.splits, stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm {p.body} launch failed: error {err}")
    return out, p


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) or (B, E, C, D); w: (E, D, F); group_sizes: (E,) or
    (B, E) int32: contiguous CUDA tensors, x and w of one type (float32 or
    bfloat16).  Returns (E, C, F) or (B, E, C, F) in x's type: each
    group's rows times its expert's weights, summed in float32, rows >=
    the group's size zero."""
    return launch(x, w, group_sizes)[0]
