"""Masked coordinate-robust client aggregation (K5) — the port of
``repro/kernels/robust_agg.py`` onto a hand-written CUDA kernel
(``csrc/robust_agg.cu``), and the stable-rank network the robust kernels
share.

``robust_agg_fwd`` is the standalone masked trimmed mean or median over a
(C, N) matrix of client updates, with no cosine gate and no weights.  Its
formulas are K2's rank modes (``robust_pipeline.gated_combine`` with the
team mask as the gated mask), and the CUDA entry point runs K2's kernel
body, so the two agree bit for bit under the same mask.  Unlike the TPU
kernel it takes any N (no block-multiple contract) and any C whose
(C, 128) tile fits in shared memory.

Dispatch: a CUDA tensor launches the kernel or the wrapper raises; a CPU
tensor runs ``robust_agg_fwd_plain``.  ``robust_agg_fwd.launches`` counts
the launches by mode.
"""
from __future__ import annotations

import torch

_BIG = 1e30
MODES = {"trimmed": 1, "median": 2}


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


def robust_agg_fwd_plain(x, mask, *, mode="trimmed", trim_frac=0.2):
    """The plain version of K5: the rank network over column chunks
    (``robust_pipeline.gated_combine_plain`` with the team mask as the
    gated mask)."""
    from repro_torch.kernels import robust_pipeline as rp
    if mode not in MODES:
        raise ValueError(mode)
    m = mask.float()[None]
    return rp.gated_combine_plain(x[None], m, m, mode=mode,
                                  trim_frac=trim_frac)[0]


def robust_agg_fwd(x, mask, *, mode="trimmed", trim_frac=0.2):
    """K5.  x: (C, N) fp32, mask: (C,) 0/1 -> (N,) fp32: per coordinate the
    mean of the masked-in rows ranked in [t, n - t) with t =
    floor(trim_frac * n) (``trimmed``), or the mean of the rows ranked
    floor((n-1)/2) and ceil((n-1)/2) (``median``), n = sum(mask).  An empty
    mask gives exactly 0.

    Replaces ``repro/kernels/robust_agg.py:robust_agg_fwd``.  Bound: bytes
    (one read of x, one write of the row; the C^2 compares per column stay
    under it at C = 16).  Design: K2's body (``ra_fwd`` runs
    ``launch_combine<DenseRows>``): columns ranked from registers for
    C <= 64, from a (C, 128) shared-memory tile past that.
    """
    from repro_torch.kernels import _build, robust_pipeline as rp
    if mode not in MODES:
        raise ValueError(mode)
    if x.dim() != 2:
        raise ValueError(f"robust_agg_fwd takes (C, N), got {tuple(x.shape)}")
    if not rp._dispatch(x):
        return robust_agg_fwd_plain(x, mask, mode=mode, trim_frac=trim_frac)
    (mask,) = rp._check_cuda(x[None], mask)
    C, N = x.shape
    rp.check_combine_smem(C, N, mode)
    out = torch.empty(N, device=x.device)
    rp._launch(_build.load().ra_fwd, x.data_ptr(), mask.data_ptr(),
               out.data_ptr(), C, N, rp.COMBINE_THREADS, MODES[mode],
               float(trim_frac))
    robust_agg_fwd.launches[mode] += 1
    return out


def reset_launch_counts():
    robust_agg_fwd.launches = {m: 0 for m in MODES}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {f"robust_agg_fwd[{m}]": n
            for m, n in robust_agg_fwd.launches.items()}


reset_launch_counts()
