"""ctypes wrapper of the CUDA ``moe_gmm`` kernel.

``csrc/moe_gmm.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, on first use (never at import),
into ``build/repro_torch/moe_gmm-<hash>/`` at the root of the checkout
(:mod:`repro_torch.kernels.nvcc`).  A missing ``nvcc`` raises: there is no
fallback.  The source's notes say what bounds the kernel and how it is
laid out.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
NVCC_FLAGS = nvcc.SM90A

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the shared library's path."""
    return nvcc.build(SOURCE, "moe_gmm", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.moe_gmm_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) or (B, E, C, D); w: (E, D, F); group_sizes: (E,) or
    (B, E) int32: contiguous CUDA tensors, x and w of one type (float32 or
    bfloat16).  Returns (E, C, F) or (B, E, C, F) in x's type: each
    group's rows times its expert's weights, summed in float32, rows >=
    the group's size zero."""
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
    f = w.shape[2]
    out = torch.empty((*lead, e, c, f), dtype=x.dtype, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_gmm_launch(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), int(x.dtype == torch.bfloat16),
            group_sizes.numel(), e, c, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm launch failed: CUDA error {err}")
    return out
