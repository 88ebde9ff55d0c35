"""FP64 rates of the card, for the RWKV-6 scan kernel's (K5) design.

    PYTHONPATH=src python -m benchmarks.torch_fp64_rates [--out FILE]

Builds ``benchmarks/csrc/fp64_rates.cu`` (which includes the scan
kernel's source, so its ``exp_scan`` is the one the kernel runs) and
prints, beside the card's name, power limit and SM clock (now and its
maximum, at which cycles are counted):

* for each FP64 tensor-core product the kernel could use (``mma.sync``
  m8n8k4, and sm_90's m16n8k4, m16n8k8 and m16n8k16), whether one
  product through the fragment layouts the source assumes equals the
  product on the host (to 1e-12), the latency of one dependent product
  (one warp, one chain) and the rate with 4 and 8 chains a warp over 4
  blocks of 8 warps an SM, in multiply-adds a clock and SM and in
  TFLOP/s, and over one block of 4 warps an SM (one warp a scheduler);
* the vector DFMA's rate the same way;
* CUDA's double ``exp`` and the kernel's ``exp_scan``, exponentials a
  clock and SM.

Times come from CUDA events around one launch after a warm-up launch.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.rwkv6_scan import kernel as rw_kernel

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16")
MNK = ((8, 8, 4), (16, 8, 4), (16, 8, 8), (16, 8, 16))


def card() -> tuple[str, float]:
    """The card's name, power limit, SM clock now and its maximum; cycles
    are counted at the maximum, the clock the card holds under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    return out, float(out.split(",")[-1])


def load():
    src = ROOT / "benchmarks" / "csrc" / "fp64_rates.cu"
    text = src.read_text().replace(
        '"../../src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu"',
        f'"{rw_kernel.SOURCE}"')
    key = abs(hash(text + rw_kernel.SOURCE.read_text()))
    copy = nvcc.BUILD_ROOT / "fp64_rates_src" / str(key) / "fp64_rates.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    lib = ctypes.CDLL(str(nvcc.build(copy, "fp64_rates", nvcc.SM90A)))
    lib.fp64_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.fp64_mma_layout.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    return lib


def timed(lib, which, ilp, grid, block, iters) -> float:
    """ms of one launch (after a warm-up)."""
    inp = torch.rand(64, dtype=torch.float64, device="cuda") * 0.01 + 0.5
    out = torch.empty(grid * block, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        if lib.fp64_rate(which, ilp, grid, block, inp.data_ptr(),
                         out.data_ptr(), iters, stream) != 0:
            raise SystemExit(f"fp64_rate {which} failed")
        ev1.record()
        torch.cuda.synchronize()
    return ev0.elapsed_time(ev1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = load()
    line, mhz = card()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"FP64 rates on {line} ({n_sm} SMs)")
    res = {"card": line, "sm_mhz": mhz, "mma": {}}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    grid, block, iters = 4 * n_sm, 256, 2048
    for s, (name, (m, n, k)) in enumerate(zip(SHAPES, MNK)):
        am, bm = rng.normal(size=(m, k)), rng.normal(size=(k, n))
        ad, bd = (torch.from_numpy(x).cuda() for x in (am, bm))
        cd = torch.zeros((m, n), dtype=torch.float64, device="cuda")
        err = lib.fp64_mma_layout(s, ad.data_ptr(), bd.data_ptr(),
                                  cd.data_ptr(), stream)
        torch.cuda.synchronize()
        ok = err == 0 and np.allclose(cd.cpu().numpy(), am @ bm, rtol=1e-12,
                                      atol=1e-12)
        fma = m * n * k
        lat_ms = timed(lib, s, 1, 1, 32, iters)
        row = {"layout_ok": bool(ok),
               "latency_cycles": lat_ms * 1e-3 * mhz * 1e6 / iters}
        for ilp in (4, 8):
            ms = timed(lib, s, ilp, grid, block, iters)
            fmas = grid * (block // 32) * iters * ilp * fma
            row[f"ilp{ilp}_fma_per_clk_sm"] = fmas / (ms * 1e-3 * mhz * 1e6
                                                      * n_sm)
            row[f"ilp{ilp}_tflops"] = 2 * fmas / (ms * 1e-3) / 1e12
            # one warp a scheduler: one block of 4 warps an SM
            ms = timed(lib, s, ilp, n_sm, 128, iters)
            fmas = n_sm * 4 * iters * ilp * fma
            row[f"ilp{ilp}_4warps_fma_per_clk_sm"] = fmas / (
                ms * 1e-3 * mhz * 1e6 * n_sm)
        res["mma"][name] = row
        print(f"  {name:9s} layout {'ok' if ok else 'WRONG'}; latency "
              f"{row['latency_cycles']:.1f} cycles; 4 chains a warp "
              f"{row['ilp4_fma_per_clk_sm']:.1f} FMA/clk/SM "
              f"({row['ilp4_tflops']:.2f} TFLOP/s), 8 chains "
              f"{row['ilp8_fma_per_clk_sm']:.1f} "
              f"({row['ilp8_tflops']:.2f} TFLOP/s); one warp a scheduler, "
              f"4 / 8 chains: {row['ilp4_4warps_fma_per_clk_sm']:.1f} / "
              f"{row['ilp8_4warps_fma_per_clk_sm']:.1f} FMA/clk/SM")
    ms = timed(lib, 4, 8, grid, block, iters)
    fmas = grid * block * iters * 8
    res["dfma_fma_per_clk_sm"] = fmas / (ms * 1e-3 * mhz * 1e6 * n_sm)
    res["dfma_tflops"] = 2 * fmas / (ms * 1e-3) / 1e12
    print(f"  DFMA, 8 chains a thread: {res['dfma_fma_per_clk_sm']:.1f} "
          f"FMA/clk/SM ({res['dfma_tflops']:.2f} TFLOP/s)")
    for which, name in ((5, "CUDA exp"), (6, "exp_scan")):
        ms = timed(lib, which, 8, grid, block, iters // 4)
        n_exp = grid * block * (iters // 4) * 8
        res[name] = n_exp / (ms * 1e-3 * mhz * 1e6 * n_sm)
        print(f"  {name}: {res[name]:.2f} exponentials/clk/SM")
    if a.out:
        Path(a.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
