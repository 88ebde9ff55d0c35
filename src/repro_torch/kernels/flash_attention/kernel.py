"""ctypes wrapper of the CUDA ``flash_attention`` kernel.

``csrc/flash_attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C entry point, on first use (never at
import), into ``build/repro_torch/flash_attention-<hash>/`` at the root of
the checkout (:mod:`repro_torch.kernels.nvcc`).  A missing ``nvcc``
raises: there is no fallback.  The source's notes say what bounds the
kernel and how it is laid out.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NVCC_FLAGS = nvcc.SM90A
HEAD_DIMS = (16, 32, 64, 128, 256)

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the shared library's path."""
    return nvcc.build(SOURCE, "flash_attention", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel's float4 reads can take it (unit
    stride along the head dim, other strides multiples of 4, 16-byte
    aligned), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) CUDA tensors of one type
    (float32 or bfloat16), ``H`` a multiple of ``Hkv``, ``Sq <= Skv``,
    ``hd`` one of :data:`HEAD_DIMS`.  Returns (B, Sq, H, hd) in q's type.
    The cache slices decode passes (``cache[:, :pos + 1]``) are read in
    place through their strides."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device});"
                             " CPU tensors take the plain version via ops")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mixed types {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on several devices")
    b, sq, h, hd = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv "
                         "heads")
    if sq > skv:
        raise ValueError(f"Sq = {sq} > Skv = {skv}: rows would see no key")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, hkv, sq, skv, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
