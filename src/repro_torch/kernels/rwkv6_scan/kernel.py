"""ctypes wrapper of the CUDA ``rwkv6_scan`` kernel.

``csrc/rwkv6_scan.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, on first use (never at import),
into ``build/repro_torch/rwkv6_scan-<hash>/`` at the root of the checkout
(:mod:`repro_torch.kernels.nvcc`).  A missing ``nvcc`` raises: there is no
fallback.  The source's notes say what bounds the kernel and how it is
laid out: one block of ``2 K`` threads a (batch, head), the state in the
FP64 tensor cores' accumulator tiles.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
NVCC_FLAGS = nvcc.SM90A
CHUNK = 16
HEAD_DIMS = (16, 32, 64)
BLOCKS_PER_HEAD = 1

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the shared library's path."""
    return nvcc.build(SOURCE, "rwkv6_scan", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.rwkv6_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None):
    """r/k/v/logw: (B, H, T, K) float32 CUDA tensors, each with unit stride
    along K (any other strides: the model's (B, T, H, K) tensors seen as
    (B, H, T, K) are read in place); u: (H, K); s0: (B, H, K, K) or None
    (zeros).  ``T`` a multiple of 16, ``K`` one of :data:`HEAD_DIMS`; logw
    already clamped at -4.  Returns ``y`` (B, H, T, K), a view of a
    (B, T, H, K) tensor, and the final state (B, H, K, K)."""
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("s0", s0)):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device});"
                             " CPU tensors take the plain version via ops")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError("the inputs lie on several devices")
    b, h, t_len, kd = r.shape
    for name, x in (("k", k), ("v", v), ("logw", logw)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != r "
                             f"{tuple(r.shape)}")
    if kd not in HEAD_DIMS:
        raise ValueError(f"head dim {kd} not in {HEAD_DIMS}")
    if t_len % CHUNK:
        raise ValueError(f"T = {t_len} is not a multiple of {CHUNK}")
    if u.shape != (h, kd):
        raise ValueError(f"u {tuple(u.shape)} != {(h, kd)}")
    if s0 is not None and s0.shape != (b, h, kd, kd):
        raise ValueError(f"s0 {tuple(s0.shape)} != {(b, h, kd, kd)}")
    r, k, v, logw = (x if x.stride(-1) == 1 else x.contiguous()
                     for x in (r, k, v, logw))
    u = u.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    y = torch.empty((b, t_len, h, kd), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    s_fin = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(*(
        s for x in (r, k, v, logw, y) for s in x.stride()[:3]))
    lib = _load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_fin.data_ptr(), b, h, t_len, kd, strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    return y, s_fin
