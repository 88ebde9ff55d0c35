"""Plain PyTorch grouped expert matmul: the kernel's oracle and its CPU
path.

The same function as ``repro.kernels.moe_gmm.ref.gmm_ref``: the product in
float32, rows at or past an expert's group size set to zero, the result
cast back to x's type.  A leading batch axis is the reference model's
``becd,edf`` einsum written out: every batch row's groups share the
experts' weights.  Below it, the coverage probe the kernel's card tests
and ``chip_smoke.py`` hold each body to exactly.
"""
from __future__ import annotations

import math

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) or (B, E, C, D); w: (E, D, F); group_sizes: (E,) or
    (B, E), the valid rows of each group.  Returns (E, C, F) or
    (B, E, C, F) in x's type with rows >= group size zeroed."""
    out = torch.einsum("...ecd,edf->...ecf", x.to(torch.float32),
                       w.to(torch.float32))
    c = x.shape[-2]
    rows = torch.arange(c, device=x.device)
    valid = rows < group_sizes.to(x.device)[..., None]     # (..., E, C)
    return torch.where(valid[..., None], out, 0.0).to(x.dtype)


# ------------------------------------------------------- coverage probe ----
# Each x row holds one or two 1s at columns chosen per (group, row), and
# w[e, k, n] = 1 + (7 e + 3 k + 5 n) mod 61, a small integer that changes
# with the expert, with a shift of k by a tile of 64 and with a shift of n
# by 1, 64 or 128.  Every product is then a sum of at most two such
# integers, exact in float32 and in bf16, so a dropped k tile, a row or
# column shifted at a tile edge, a wrong expert (g % E) or a row past its
# group's size shows as an exact mismatch.  The sizes cycle through the
# tile edges, C - 1, C, more than C and a negative size.
PROBE_SIZES = (0, 1, 63, 64, 65, 127, 128, 129)


def probe_sizes(lead: tuple, e: int, c: int, device=None) -> torch.Tensor:
    """(*lead, E) int32: :data:`PROBE_SIZES`, ``C - 1``, ``C``, ``C + 5``
    and -3, cycled over the groups."""
    cycle = PROBE_SIZES + (c - 1, c, c + 5, -3)
    sizes = [cycle[i % len(cycle)] for i in range(e * math.prod(lead))]
    return torch.tensor(sizes, dtype=torch.int32,
                        device=device).reshape(*lead, e)


def _probe_columns(g: int, c: int, d: int, device=None):
    """(G, C) int64 each: the first column of each row's 1s and the second
    (-1 where the row holds one 1)."""
    gi = torch.arange(g, device=device)[:, None]
    r = torch.arange(c, device=device)[None, :]
    k1 = (gi * 131 + r * 37) % d
    k2 = (k1 + 1 + (gi + 3 * r) % max(d - 1, 1)) % d
    one = ((gi + r) % 3 == 0) | (d == 1)
    return k1, torch.where(one, -1, k2)


def _probe_code(ex: torch.Tensor, k: torch.Tensor, n: torch.Tensor):
    return 1 + (7 * ex + 3 * k + 5 * n) % 61


def probe_inputs(lead: tuple, e: int, c: int, d: int, f: int, dtype,
                 device=None):
    """(x (*lead, E, C, D), w (E, D, F), sizes (*lead, E)) of the coverage
    probe, x and w in ``dtype``."""
    g = e * math.prod(lead)
    k1, k2 = _probe_columns(g, c, d, device)
    x = torch.zeros((g, c, d), dtype=dtype, device=device)
    x.scatter_(2, k1[..., None], 1.0)
    two = k2 >= 0
    gi, ri = torch.nonzero(two, as_tuple=True)
    x[gi, ri, k2[two]] = 1.0
    w = _probe_code(torch.arange(e, device=device)[:, None, None],
                    torch.arange(d, device=device)[None, :, None],
                    torch.arange(f, device=device)[None, None, :])
    return (x.reshape(*lead, e, c, d), w.to(dtype),
            probe_sizes(lead, e, c, device))


def probe_expected(lead: tuple, e: int, c: int, d: int, f: int,
                   device=None) -> torch.Tensor:
    """(*lead, E, C, F) float32: the probe's product, from the column and
    weight codes alone (no product is computed)."""
    g = e * math.prod(lead)
    k1, k2 = _probe_columns(g, c, d, device)
    ex = (torch.arange(g, device=device) % e)[:, None, None]
    n = torch.arange(f, device=device)[None, None, :]
    out = _probe_code(ex, k1[..., None], n)
    out = out + torch.where(k2[..., None] >= 0,
                            _probe_code(ex, k2[..., None], n), 0)
    sizes = probe_sizes(lead, e, c, device).reshape(g).clamp(0, c)
    past = torch.arange(c, device=device)[None, :] >= sizes[:, None]
    out = torch.where(past[..., None], 0, out)
    return out.to(torch.float32).reshape(*lead, e, c, f)
