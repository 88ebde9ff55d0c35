"""The RWKV-6 scan kernel's coverage probe: inputs on which every sum is
exact, so the kernel must equal its plain version bitwise.

With ``logw = 0`` every decay factor is ``exp(0) = 1`` and with small
integer r, k, v, u and initial state every product and partial sum is an
integer far below 2^24: the step-by-step plain version (float32), the
kernel's chunked form (double, its sums in another order) and any correct
schedule give the same numbers, bit for bit.  A row or a state column
that a chunk, a tile or a lane leaves out, counts twice or reads from the
wrong step changes some integer of the result.
"""
from __future__ import annotations

import numpy as np
import torch

# (T, with a random initial state): one chunk, two, three (a chunk past a
# whole number of tiles) and the serving path's prompt
PROBE_T = (16, 32, 48, 2048)
HEAD_DIMS = (16, 32, 64)


def probe_inputs(b: int, h: int, t: int, k: int, *, state: bool,
                 seed: int = 0, device=None):
    """``(r, k, v, logw, u, s0)`` float32 of shape (B, H, T, K) (u (H, K),
    s0 (B, H, K, K)): r, k, v, u in [-2, 2], s0 in [-8, 8] (zeros without
    ``state``), logw 0, drawn with numpy from ``seed``.  At T = 2048 and
    K = 64 the largest partial sum is below 2^21."""
    rng = np.random.default_rng(seed)
    ints = lambda lo, hi, *s: torch.from_numpy(
        rng.integers(lo, hi + 1, size=s).astype(np.float32)).to(device)
    r, kk, v = (ints(-2, 2, b, h, t, k) for _ in range(3))
    u = ints(-2, 2, h, k)
    s0 = (ints(-8, 8, b, h, k, k) if state
          else torch.zeros((b, h, k, k), device=device))
    logw = torch.zeros((b, h, t, k), device=device)
    return r, kk, v, logw, u, s0


def probe_cases():
    """``(K, T, state)`` of the probe: every head dim, every T of
    :data:`PROBE_T`, from a zero and a random-integer state."""
    return [(k, t, s) for k in HEAD_DIMS for t in PROBE_T
            for s in (False, True)]
