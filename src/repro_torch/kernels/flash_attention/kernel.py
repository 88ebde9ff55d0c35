"""ctypes wrapper of the CUDA ``flash_attention`` kernels.

``csrc/flash_attention.cu`` (with ``csrc/wgmma.cuh``) is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point
per body, on first use (never at import), into
``build/repro_torch/flash_attention-<hash>/`` at the root of the checkout
(:mod:`repro_torch.kernels.nvcc`).  A missing ``nvcc`` raises: there is no
fallback.

:func:`plan` names the body a call takes, from the shapes and the type
alone, and :func:`launch` calls that body's entry point:

* ``tc_prefill``: bf16 at head dims 64 / 128 / 256 with at least
  :data:`TC_MIN_ROWS` query rows; both products on the tensor cores
  (wgmma), K/V tiles fed by TMA;
* ``split_decode``: ``Sq x group <= DECODE_ROWS`` rows in either type; one
  block per (kv split, kv head, batch row) reads each K/V byte once (in
  bf16 at head dims 64 / 128 / 256 through the tensor cores, else on CUDA
  cores), a second kernel merges the splits in order;
* ``fp32_prefill``: everything else (float32 prefill; bf16 at head dims 16
  and 32, or with too few rows for a tensor-core tile and too many for a
  decode block), on CUDA cores in float32.

The source's notes say what bounds each body and how it is laid out.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NVCC_FLAGS = nvcc.SM90A
HEAD_DIMS = (16, 32, 64, 128, 256)
BODIES = ("tc_prefill", "split_decode", "fp32_prefill")
TC_HEAD_DIMS = (64, 128, 256)
TC_MIN_ROWS = 64          # one consumer warpgroup's query rows
DECODE_ROWS = 64          # Sq x group rows one split block holds
# the split count covers the card SPLIT_WAVES times over, with at least
# MIN_SPLIT_KEYS keys a split, each split a whole number of the tensor-core
# decode's SPLIT_ALIGN-key tiles (recurrentgemma's 4 (batch row, kv head)
# pairs take 32 splits of its 2,048-row ring)
SPLIT_WAVES = 2
MIN_SPLIT_KEYS = 64
SPLIT_ALIGN = 64
H100_SMS = 132

_lib = None
_sms: dict = {}


class Plan(NamedTuple):
    """The body a call takes; for ``split_decode``, split ``s`` of
    ``splits`` reads keys ``[kv_lo + s * chunk, min(kv_lo + (s + 1) *
    chunk, kv_hi))``."""
    body: str
    splits: int = 1
    chunk: int = 0
    kv_lo: int = 0
    kv_hi: int = 0


def split_keys(b: int, hkv: int, sq: int, skv: int, window: int = 0,
               sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """(splits, chunk, kv_lo, kv_hi) of a split decode: the keys some row
    sees (the last row sees up to ``skv - 1``; the window cuts the first
    row's past), cut into chunks of a multiple of :data:`SPLIT_ALIGN` keys,
    about as many as cover the card :data:`SPLIT_WAVES` times with ``b *
    hkv`` blocks a split, but no fewer than :data:`MIN_SPLIT_KEYS` keys a
    chunk; no split is empty."""
    kv_lo = max(0, skv - sq - window + 1) if window > 0 else 0
    n = skv - kv_lo
    want = -(-SPLIT_WAVES * sms // max(1, b * hkv))
    splits = max(1, min(want, n // MIN_SPLIT_KEYS))
    chunk = -(-max(1, -(-n // splits)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-n // chunk), chunk, kv_lo, skv


def plan(q_shape, k_shape, dtype: torch.dtype, *, window: int = 0,
         sms: int = H100_SMS) -> Plan:
    """The body for q (B, Sq, H, hd) against k (B, Skv, Hkv, hd) of
    ``dtype``, and its key split."""
    b, sq, h, hd = q_shape
    _, skv, hkv, _ = k_shape
    if sq * (h // hkv) <= DECODE_ROWS:
        return Plan("split_decode", *split_keys(b, hkv, sq, skv, window,
                                                sms))
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and sq >= TC_MIN_ROWS:
        return Plan("tc_prefill")
    return Plan("fp32_prefill")


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source has not been built yet) and
    return the shared library's path."""
    return nvcc.build(SOURCE, "flash_attention", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i, ll, f, p = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                       ctypes.c_void_p)
        lib.fa_fp32_prefill_launch.argtypes = (
            [p] * 4 + [i] * 7 + [ll] * 9 + [i] * 2 + [f, p])
        lib.fa_tc_prefill_launch.argtypes = (
            [p] * 4 + [i] * 6 + [ll] * 9 + [i] * 2 + [f, p])
        lib.fa_split_decode_launch.argtypes = (
            [p] * 6 + [i] * 7 + [ll] * 9 + [i] * 2 + [f] + [i] * 4 + [p])
        for fn in (lib.fa_fp32_prefill_launch, lib.fa_tc_prefill_launch,
                   lib.fa_split_decode_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def _strides(t: torch.Tensor) -> list[int]:
    """``t``'s strides, a size-1 dim's replaced by the stride it would have
    if ``t`` were contiguous over it (any value reads the same element)."""
    st = list(t.stride())
    for d in range(t.dim() - 2, -1, -1):
        if t.shape[d] == 1:
            st[d] = st[d + 1] * t.shape[d + 1]
    return st


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where every body can read it in place (unit stride along
    the head dim, every other stride a multiple of 16 bytes, as TMA and the
    16-byte loads need, 16-byte aligned), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s * t.element_size() % 16 == 0 for s in _strides(t)[:-1]))
    return t if ok else t.contiguous()


def _check(q, k, v):
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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0, softcap: float = 0.0,
           body: str | None = None) -> tuple[torch.Tensor, Plan]:
    """:func:`flash_attention`'s output and the :class:`Plan` it ran.
    ``body = "fp32_prefill"`` runs that body in place of the plan's (it
    takes every call), to time one body against another on the same
    inputs; any other body the plan does not name raises."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    _, skv, hkv, _ = k.shape
    p = plan(q.shape, k.shape, q.dtype, window=int(window),
             sms=sm_count(q.device))
    if body is not None and body != p.body:
        if body != "fp32_prefill":
            raise ValueError(f"{body} cannot take this call; its plan is "
                             f"{p.body}")
        p = Plan(body)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out, p
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    strides = _strides(q)[:3] + _strides(k)[:3] + _strides(v)[:3]
    lib = _load()
    bf16 = int(q.dtype == torch.bfloat16)
    feat = (int(causal), int(window), float(softcap))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.body == "tc_prefill":
            err = lib.fa_tc_prefill_launch(*ptrs, b, h, hkv, sq, skv, hd,
                                           *strides, *feat, stream)
        elif p.body == "split_decode":
            rows = b * sq * h
            part_acc = torch.empty((rows, p.splits, hd), dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty((rows, p.splits, 2), dtype=torch.float32,
                                  device=q.device)
            err = lib.fa_split_decode_launch(
                *ptrs, part_acc.data_ptr(), part_ml.data_ptr(), bf16, b, h,
                hkv, sq, skv, hd, *strides, *feat, p.kv_lo, p.kv_hi,
                p.chunk, p.splits, stream)
        else:
            err = lib.fa_fp32_prefill_launch(*ptrs, bf16, b, h, hkv, sq, skv,
                                             hd, *strides, *feat, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {p.body} launch failed: "
                           f"error {err}")
    return out, p


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) CUDA tensors of one type
    (float32 or bfloat16), ``H`` a multiple of ``Hkv``, ``Sq <= Skv``,
    ``hd`` one of :data:`HEAD_DIMS`.  Returns (B, Sq, H, hd) in q's type.
    The cache slices and rings decode passes (``cache[:, :pos + 1]``) are
    read in place through their strides."""
    return launch(q, k, v, causal=causal, window=window, softcap=softcap)[0]
