"""Plain PyTorch grouped expert matmul: the kernel's oracle and its CPU
path.

The same function as ``repro.kernels.moe_gmm.ref.gmm_ref``: the product in
float32, rows at or past an expert's group size set to zero, the result
cast back to x's type.  A leading batch axis is the reference model's
``becd,edf`` einsum written out: every batch row's groups share the
experts' weights.
"""
from __future__ import annotations

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
