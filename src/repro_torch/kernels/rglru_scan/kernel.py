"""ctypes wrapper of the CUDA ``rglru_scan`` kernel.

``csrc/rglru_scan.cu`` is compiled with ``nvcc`` for ``sm_90a`` (and
``--fmad=false``, so each step rounds its multiply and its add as the
plain version does) into a shared library with a plain C entry point, on
first use (never at import), into ``build/repro_torch/rglru_scan-<hash>/``
at the root of the checkout (:mod:`repro_torch.kernels.nvcc`).  A missing
``nvcc`` raises: there is no fallback.  The source's notes say what
bounds the kernel and how it is laid out.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
NVCC_FLAGS = nvcc.SM90A + ("--fmad=false",)
MAX_BATCH = 65535             # the grid's y extent

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the shared library's path."""
    return nvcc.build(SOURCE, "rglru_scan", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.rglru_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor):
    """log_a/b: (B, T, W) float32 CUDA tensors; the initial state is zero
    (``ops`` folds one into ``b``).  Returns (h (B, T, W), h_final (B, W)),
    float32."""
    for name, t in (("log_a", log_a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device});"
                             " CPU tensors take the plain version via ops")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B, T, W), got "
                             f"{tuple(t.shape)}")
    if b.shape != log_a.shape:
        raise ValueError(f"b {tuple(b.shape)} != log_a {tuple(log_a.shape)}")
    if b.device != log_a.device:
        raise ValueError("log_a and b lie on different devices")
    bsz, t_len, w = log_a.shape
    if bsz > MAX_BATCH:
        raise ValueError(f"B = {bsz} > {MAX_BATCH}")
    log_a, b = log_a.contiguous(), b.contiguous()
    h = torch.empty_like(log_a)
    h_fin = torch.empty((bsz, w), dtype=torch.float32, device=log_a.device)
    lib = _load()
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_launch(log_a.data_ptr(), b.data_ptr(),
                                    h.data_ptr(), h_fin.data_ptr(), bsz,
                                    t_len, w, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return h, h_fin
