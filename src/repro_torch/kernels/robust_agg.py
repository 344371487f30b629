"""The stable-rank network shared by the robust-aggregation kernels (port
of ``repro/kernels/robust_agg.py:stable_ranks``).

The standalone masked trimmed-mean / median kernel of that module
(``robust_agg_fwd``) is still to be ported (ROADMAP queue 2, K5).
"""
from __future__ import annotations

import torch

_BIG = 1e30


def stable_ranks(xm):
    """Per-coordinate stable ranks over the client axis of an already
    masked (..., C, n) block: rank_i = #{j: x_j < x_i} + #{j<i: x_j == x_i}.
    Masked-out rows must arrive pushed to +_BIG.  Returns float32 ranks of
    the same shape; the CUDA kernels run the same O(C^2) compare network
    per column."""
    c = xm.shape[-2]
    xi = xm.unsqueeze(-2)                         # (..., C, 1, n)
    xj = xm.unsqueeze(-3)                         # (..., 1, C, n)
    row = torch.arange(c, device=xm.device)
    earlier = (row[None, :] < row[:, None])[:, :, None]   # j < i
    return ((xj < xi) | ((xj == xi) & earlier)).sum(-2).float()
