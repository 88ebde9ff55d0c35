"""How far the RWKV-6 scan's float32 results lie from the exact recurrence.

    PYTHONPATH=src python -m benchmarks.torch_rwkv6_precision
    PYTHONPATH=src python -m benchmarks.torch_rwkv6_precision --reference

Inputs are drawn as ``chip_smoke.py`` draws them (r, k, v, u and a random
initial state from N(0, 1), logw = max(-exp(N(0, 0.25)), -4)), three
seeds, each from a zero and a random state.  The exact recurrence is the
step-by-step scan in float64.  For each result (y and the final state) it
prints the max abs error and the largest ratio of an element's error to
the rtol = atol = 2e-5 bound the kernel is held to (1 is the bound).

By default, on the CUDA card at the rwkv6-3b prefill's shape (B, H, T, K)
= (4, 40, 2048, 64): the scan kernel (K5) and its plain step-by-step
version, and the kernel against the plain version.  With
``--reference``, on the CPU at (1, 8, 2048, 64): the reference's float32
chunked form (``repro.models.rwkv6.wkv_chunked``, the algorithm and the
float32 rounding of the TPU kernel) and the port's plain version.
"""
from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

TOL = 2e-5


def scan64(r, k, v, lw, u, s0):
    """The recurrence step by step in float64."""
    r, k, v, lw, u, s = (x.double() for x in (r, k, v, lw, u, s0))
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s)
                  + (rt * u[None] * kt).sum(-1, keepdim=True) * vt)
        s = (torch.exp(lw[:, :, t])[..., None] * s
             + kt[..., None] * vt[..., None, :])
    return torch.stack(ys, 2), s


def inputs(shape, seed, state, device):
    b, h, t, kd = shape
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=device)
    lw = torch.clamp(-torch.exp(0.5 * mk(b, h, t, kd)), min=-4.0)
    s0 = (mk(b, h, kd, kd) if state
          else torch.zeros((b, h, kd, kd), device=device))
    return mk(b, h, t, kd), mk(b, h, t, kd), mk(b, h, t, kd), lw, mk(h, kd), s0


def gaps(got, want):
    """(max abs error, max error / bound) of y and of the state."""
    out = []
    for a, w in zip(got, want):
        d = (a.double() - w.double()).abs()
        out.append((d.max().item(),
                    (d / (TOL + TOL * w.double().abs())).max().item()))
    return out


def show(label, pairs):
    print(f"  {label}: " + "; ".join(
        f"{n} max abs {e:.3e}, {q:.3f} of the bound"
        for n, (e, q) in zip(("y", "state"), pairs)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", action="store_true",
                    help="the reference's float32 chunked form, on the CPU")
    args = ap.parse_args()
    from repro_torch.kernels.rwkv6_scan import ref
    if args.reference:
        import jax.numpy as jnp
        from repro.models.rwkv6 import wkv_chunked
        shape, dev, where = (1, 8, 2048, 64), "cpu", "CPU"
    else:
        from repro_torch.kernels.rwkv6_scan import kernel
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card (or --reference)")
        shape, dev = (4, 40, 2048, 64), "cuda"
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(f"(B, H, T, K) = {shape} on {where}")
    for seed in range(3):
        for state in (False, True):
            a = inputs(shape, seed, state, dev)
            exact = scan64(*a)
            plain = ref.wkv_ref(*a)
            print(f"seed {seed}, {'random' if state else 'zero'} state:")
            if args.reference:
                got = wkv_chunked(*(jnp.asarray(x.numpy()) for x in a))
                got = [torch.from_numpy(np.array(x)) for x in got]
                show("reference wkv_chunked (float32) vs exact",
                     gaps(got, exact))
            else:
                got = kernel.rwkv6_scan(*a)
                torch.cuda.synchronize()
                show("kernel vs exact", gaps(got, exact))
                show("kernel vs plain", gaps(got, plain))
            show("plain vs exact", gaps(plain, exact))


if __name__ == "__main__":
    main()
